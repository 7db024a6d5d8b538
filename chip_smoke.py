"""Drive the PyTorch port (rscotr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from rscotr_tpu_torch/csrc (one nvcc
   per source, in parallel);
3. kernels: K1 (MSDA forward) and K2 (Swin window attention) against their
   plain PyTorch versions at the flagship's shapes (the det and seg
   encoders at B=1 and B=4, the det decoder at 600 and 800 queries; the
   Swin stages of det 800^2, cls 224^2 and seg 512^2), in float32 and
   bfloat16, with kernel and plain times from CUDA events. K1 with both of
   its bodies on the same tensors: the vector body, which every model-path
   launch takes, and the lane-per-channel body (the first kernel), at
   locations in [0, 1] as a model's are and in [-0.2, 1.2], where about
   half the corners are off the map; a modelled-L2 line (corner rows
   loaded, counted from the locations) beside each timed case; also at the
   zoo's encoders (the paper MTL's cls encoder, RSCoTrSeg-R50's 3-level
   one). K2 also
   with q, k, v as strided views of the fused qkv
   projection, with a window count that the per-block run of windows does
   not divide, and at a head width that takes its CUDA-core instantiation
   in bf16. Each timed kernel stands beside its bound (the larger of bytes
   moved once over 3.35 TB/s and operations over the published peak);
3b. K7 (``layer_norm_phase``, the LayerNorm forward outside autograd)
   against its plain version at the main path's widths (96 to 1536, f32
   and bf16 in, f32 and bf16 out; f32 outputs at TOL's f32 bound, bf16
   ones within one bf16 ulp more), timed at the cls stage-1 block norm (802,816
   x 96, f32 in, bf16 out) and the det encoder's (212,704 x 256, f32 in
   and out) beside its bound, the plain version and ``F.layer_norm``; the
   host microseconds of a ``LayerNorm`` module call with K7 against the
   module's earlier ``F.layer_norm(x.float(), ...)``, in turns;
4. backward kernels: K1b (the whole MSDA backward in one launch, the
   value-gradient scatter fused in) and K2b (window attention backward),
   through ``torch.autograd.grad`` of the CUDA Functions, against the plain
   decomposition at the flagship's shapes (K1b at the det and seg encoders
   and the train decoder, at a head width of 64, at one that takes its
   lane-per-channel body, with locations that clamp at the map's edge, and
   at the zoo's encoders;
   K2b at K2's extra cases too), float32 and bfloat16, timed, with bounds;
   each case also through K1b's and K2b's ordered bodies (the ones
   ``torch.use_deterministic_algorithms`` picks: K1b's value gradient by
   sorted corners and a walk per row, K2b's d_rel_bias by per-block
   partials summed in block order), called twice on the same tensors: the
   two results bit-equal, each held to the same tolerance; their times
   beside the default bodies', and K1b's ordered body part by part at the
   timed cases;
   K3' (the scatter alone, which the quad-gather path runs) on the quad-row
   updates of the plain backward at the det encoder (locations in [0, 1]
   and [-0.2, 1.2]) and the train decoder, its vector body and its scalar
   body forced on the same tensors, timed at the det encoder beside one
   ``index_add_`` call, its library yardstick;
4b. attention dropout (``dropout_phase``): K2 / K2b's DROP bodies at det
   800^2 stage 0 with p = 0.1, float32 (CUDA-core) and bfloat16 (tensor
   cores), without and with the shift mask: the keep bits of both
   kernels, read through an identity v and a one-hot dO, equal
   ``ops.philox.keep_mask``'s bit for bit (the plain versions' bits), the
   keep fraction within 5 binomial sigma of 0.9, the values within K2's
   and K2b's tolerances of the plain versions, the same seed bit-equal
   and another seed not, K2b's ordered body twice bit-equal; the DROP
   bodies' device time beside the p = 0 bodies' on the timed stage's own
   tensors, in turns (``dropout_ms``);
5. quad-gather MSDA at the det encoder: ``ms_deform_attn(impl="quad")``
   forward + backward once (K4, K5 and K3' launches counted; K4, K5 and
   K3' must take their vector bodies), K4 (corner-weighted sum) and K5 (its
   gradients), each with both bodies on the same tensors, against their
   plain versions, the quad path's output and gradients against the K1
   path's, float32 and bfloat16; K4, K5 and both paths timed, with their
   peak memory, K4 beside one ``torch.bmm``, its library yardstick;
6. K6 through the probe tool (``rscotr_tpu_torch.tools.
   probe_msda_weighted_gather_mm``): its parity check, K6 against its plain
   version at the four det-encoder level shapes, float32 and bfloat16, then
   the tool's per-level timing against the plain gather x weight (K6
   launches counted);
7. slice parity: the tiny config's cls, det and seg (whole and slide mode)
   tasks on the CPU (plain versions) and on the card (kernels), float32,
   TF32 off;
8. training parity: the tiny config trains cls, det, det, cls on the CPU
   and on the card from the same weights and batches; every loss term per
   step and the final parameters are compared;
9. serving: the flagship MTL (Swin-T, 6-layer shared MSDA encoder,
   600-query DINO head, 9-layer Mask2Former head; bf16 compute, random
   weights from a seed) answers cls 16x224^2, det 1x800^2, det 4x800^2,
   seg 4x512^2 and seg 1x512^2 requests; outputs are checked, kernel
   launches counted (every K1 launch must take the vector body, every
   LayerNorm call a K7 launch), median
   latency (CUDA events) and peak memory reported;
9b. the DINO head as a CUDA graph (``det_graph_phase``, also alone:
   ``python -c "import chip_smoke; chip_smoke.det_graph_phase()"``), at
   the flagship's det request (16 x 800^2): the attention scale against
   the host-copied divisor it replaced, bit for bit on the card; the
   graph counters per request (warm-up: eager, capture, replay; then one
   replay and no eager call a request, K1 and K7 launches as the eager
   request's); each replayed request's head outputs and boxes against the
   same request run eagerly (bit-equal, or the largest gap by name); the
   head's selection and decoder timed eagerly against a replay (host
   issue and end to end, in turns); a profiled request's host
   synchronisations and its K1 kernels on the device timeline;
10. training: the flagship trains cls 16x224^2 (mixup / cutmix), det
    1x800^2 (18 GT boxes padded to 100, 5 CDN groups: 200 DN + 600 matching
    queries) and seg 4x512^2 (uint8 labels in [0, 5) with a band of the
    ignore index 255) interleaved under the per-task masks, drop path 0.2;
    losses and grad norms are checked finite, the masked modules
    bit-identical, kernel launches counted per step (every K1 and K1b
    launch on the vector body); median step time (CUDA events around the
    whole step, host matcher included), the host matcher's time and peak
    memory reported; then ``--deterministic``'s cost: the three steps with
    ``torch.use_deterministic_algorithms`` off, on, and on with torch's
    fill of new tensors off, 16 each in turns, their medians and quartiles
    (every K1b / K2b launch on its ordered body under it, none refusing
    it; the fill's share of the cost named only where the no-fill mode's
    quartiles are apart from both others'), and what the flag refuses:
    ``F.interpolate``'s antialiased bilinear backward must raise, and
    ``resize_linear``'s products there equal it; then the cls and det
    steps of a model built with Swin's ``attn_drop_rate``, the encoder's
    ``dropout`` and ``ffn_drop`` at 0.1 against the same steps at 0, in
    turns: the launches of the main path's steps (every window attention a
    K2 / K2b launch, the plain versions failing if called), median step
    time and peak memory of each;
11. on-device augmentation (``augment_phase``): the stages of
    ``ops/device_augment.py`` on the card against the same stages on the
    CPU, on records the port's planners drew for
    ``MTL_synthetic_flagship_devaug.py``'s synthetic sets: cls 16 x 256^2
    -> 224^2 (RandomResizedCrop, flip, 2 RandAugment slots, erase), det 1
    x 800^2 (the two-stage resample), seg 2 x 512^2 (the resize + crop +
    flip matrices, PhotoMetricDistortion). Each part is fed the CPU's
    output of the part before it and held to ``AUG_TOL`` (at most 1 uint8
    level on at most 0.5% of the values); each whole stage end to end
    (``run_stage``, as the step calls it) is held to ``AUG_TOL`` too, run
    again with ``allow_tf32`` on (bit-equal: the resample products hold
    full float32), timed (CUDA events, and the host's time to issue it)
    and profiled (device time, kernels per call);
12. the model zoo at full width and depth, bf16, random weights: the
    paper's MTL (``MlvlClsHead`` scheme 5, whose cls path runs the shared
    encoder) answers 3 cls 16x224^2 requests and takes 3 cls steps under
    the mask of ``cls_uses_encoder=True``; DINO-R50 (an MTL with a
    ResNet-50 backbone and the det head) 3 det 1x800^2 requests and 3 det
    steps; RSCoTrSeg-R50 (the standalone segmentor, its own 3-level
    encoder) 3 seg 2x512^2 requests and 3 seg steps without a task mask.
    Each path's timed calls follow 2 untimed warm-up calls, checked and
    counted as they are. Each config runs as written, its on-device
    augmentation on: the train batch comes from its train pipeline through
    the port's planner and aug collate over a synthetic set (cls 16 x
    256^2 sources, det 1 x 800^2 into DINO-R50's (800, 1344) bucket, seg 2
    x 512^2), and each step runs the augment stage. Every request and step
    runs with the kernel counts at 0 and is checked
    against the counts the code gives (all K1 / K1b launches on the vector
    body); outputs checked, median time and peak memory reported. K1 and
    K1b are held against their plain versions at these paths' new encoder
    shapes in phases 3 and 4 (B=16, Q=Nv=1,045, L=4; B=2, Q=Nv=5,376,
    L=3);
13. evaluation (``eval_phase``): the flagship saved with the port's
    ``save_checkpoint`` and loaded back through ``resolve_checkpoint(
    work_dir/latest.pth)`` into a model of another seed, its cls, det and
    seg outputs bit-equal to the saver's; then the port's
    ``tools/test.py`` (``rscotr_tpu_torch.tools.test.main``) on that
    checkpoint (its raw results kept with ``--out`` for phase 14) over the
    whole synthetic val sets (cls 4 x 8 x 224^2, det 2
    x 4 x 800^2, seg 2 x 4 x 512^2), launches counted per batch (K1 / K2:
    cls 0 / 12, det 12 / 12, seg 6 / 12, every K1 on the vector body, no
    backward or quad-path kernel), the metric keys (``resisc.accuracy_top-1``,
    ``dior.bbox_mAP`` and its classwise keys, ``potsdam.mIoU``,
    ``potsdam.mFscore``) and finite values checked, and per dataset the
    median batch time after one untimed batch, images/s, the loader's and
    the infer step's share of the wall time and the peak memory reported;
    the seg logits path (crop and resize on the host) timed once; the tiny
    config's ``make_val_step`` for cls, det and seg on the CPU and on the
    card, float32, TF32 off, every log var within SLICE_TOL; the
    checkpoint and the cls results stay for the tools phase;
13b. the user tools (``tools_phase``), each through its ``main``, every
    count set to 0 just before it and read just after:
    ``tools/benchmark.py`` on the flagship at full width and depth (cls,
    det and seg requests and train steps, 10 timed calls after 2, then the
    det step with ``with_cp`` on the backbone and the shared encoder, then
    ``--eval-loop``): the root tool's report keys, 0 < MFU <= 1, per call
    the K1 / K1b / K2 / K2b launches (``TOOL_WANT``, ``CP_WANT``: with_cp
    runs each encoder layer and Swin block again) and FlopCounterMode's
    count of the four kernel operators equal to ``ops/flops.py``'s
    formulas over those launches, the with_cp det step's ``train_temp_mb``
    below the plain one; ``tools/overfit_proof.py`` (``--eval-every 250
    --max-iters 4000``) in a process of its own (this script's
    ``--overfit-proof`` mode), started once the scale-out phase's timed
    runs have ended and waited for after the devaug ``--deterministic``
    runs (17), none of whose work in between prints a timing, since its
    tiny steps are host-bound: every target
    met (cls top-1 100, det mAP_50 >= 0.9, seg mIoU >= 90), the
    iterations printed, its launches counted; ``tools/parity_check.py
    dump`` of the tiny config's seeded init on the card and on the CPU
    (float32, TF32 off) and ``compare``: cls and seg within SLICE_TOL, det
    boxes within SLICE_TOL x the image size, labels equal, on the inputs
    of the first seed whose det top-k cut and seg attention-mask margins
    clear 10 x SLICE_TOL; ``featmap_vis.vis_featmap_single_img`` at
    224^2, 800^2 and 512^2 on seeded PNGs with the eval phase's flagship
    ``.pth``: the root tools' file names, K2 12 launches per image, the
    backbone's maps on the card against the CPU's within SLICE_TOL;
    ``confusion_matrix.get_cls_confusion_matrix`` on the eval phase's cls
    scores: its accuracy equal to the eval phase's, the plot skipped
    without matplotlib;
14. export and serve (``export_phase``): the host C++ libraries built
    on the machine (the COCO AP core must build; the JPEG / PNG decoder may
    lack libjpeg / libpng, which alone is printed and passed over), the
    native AP on the eval phase's det results equal to the numpy AP within
    1e-6; the seed-0 flagship saved as a ``.pth`` and exported by the
    port's ``tools/export_model.py --device cuda --input-dtype uint8
    --check`` (``torch.export`` programs calling K1 and K2 as
    ``rscotr_torch::msda_fwd`` / ``window_attn_fwd``) at the buckets cls
    16x224^2, det 4x800^2, seg 4x512^2, trace seconds and bytes reported;
    ``tools/serve.py`` in a process of its own on 8 PNGs of mixed sizes,
    importing no model module, its results.json and seg PNGs against the
    live steps on the same preprocessed batches (labels and seg maps equal,
    scores and boxes within a bf16 bound); ``tools/test.py --show-dir``
    (one batch per val set, 16 PNGs) and ``tools/inference_one_img.py``;
    per artifact request of each task the K1 / K2 launches (cls 0 / 12,
    det 12 / 12, seg 6 / 12, every K1 on the vector body, nothing else),
    then artifact and live requests timed in turns (CUDA events, median of
    20 warm calls) with the peak memory above the resident weights;
15. the co-training loop (``loop_phase``): the port's ``tools/train.py``
    (``rscotr_tpu_torch.tools.train.main``) on the flagship config as
    written (round_robin, ``steps_per_dispatch=16``: JAX's grouped order)
    for 48 iterations in a temporary work dir: the task of every step
    against the order the port's grouping derives without a step (16 cls,
    16 det, 16 seg), every iteration's launches (cls K2 / K2b 12; det K1 /
    K1b / K2 / K2b 12; seg K1 / K1b 6, K2 / K2b 12; every K1 / K1b on the
    vector body, no quad-path kernel), every loss term and grad_norm
    finite, ``iter_48.pth``, ``last_checkpoint``, ``best_checkpoint.pth``
    and ``metrics.jsonl`` (steps 5, 10, ..., 45, 48), the eval hook at step
    48 over the whole val sets with the eval phase's per-batch counts and
    metric keys; then a resume from ``iter_48.pth`` to 52: model and
    optimizer state bit-equal to the file, start at step 48 with the
    optimizer's schedule clock at 48, 4 cls steps counted as above.
    Reported per task: the median step time (CUDA events around the step
    call) and host wall after each group's first step, the median
    data_time, the peak memory; the loop's data-wait share, the
    checkpoint save and load times, the eval hook's time, the phase's;
16. co-training with the paper's augmentation (``aug_loop_phase``): the
    port's ``tools/train.py`` on ``MTL_synthetic_flagship_devaug.py`` (the
    three augment tails in the steps, on the card) and on
    ``MTL_synthetic_flagship_hostaug.py`` (the same tails on the host: PIL
    RandAugment, resize, crop, photometric in the loader threads), each as
    written for 48 iterations (16 cls, 16 det, 16 seg), in the order
    hostaug, devaug, hostaug (the soak's legs, 16b, run the devaug config
    with the same checks); all ``--no-validate``. Every iteration's task
    and K1 / K1b / K2 / K2b launches (on the vector body) checked as in the
    loop phase, every loss term finite, the totals, a parameter of the
    backbone and of each head moved; reported as the loop phase's, per run
    the data-wait share over all steps and after step 1 (the steady wait)
    beside each group's collection, the two configs' runs side by side, and
    each augment stage's time as a share of its task's devaug step;
16b. the soak (``soak_phase``), the short form of ``python -m
    rscotr_tpu_torch.tools.soak_flagship`` through its ``soak`` on
    ``MTL_synthetic_flagship_devaug.py``: ``SOAK_ITERS`` (96) iterations,
    a log record every 16, eval every 48, each leg a process of its own
    (this script's ``--soak-leg`` mode: the train tool through
    ``train_cli_run``, every count at 0 just before it); SIGTERM to phase
    1 ``SOAK_KILL_DELAY`` after its ``metrics.jsonl`` holds a record at
    step 48 or later (an event, not a clock), then phase 2 resumes with
    ``--auto-resume`` to 96. Checked: the preemption checkpoint
    ``iter_N.pth`` with 48 < N < 96, phase 1's rc 124 and phase 2's 0,
    each leg's steps in the derived grouped order (phase 2's from N, a
    fresh data stream), its launches per iteration the devaug loop's, every
    loss term finite, each leg's one eval (at 48, at 96) in its totals, the
    records' steps continuing from N, two ``val/`` records; printed: the
    soak's own lines (the drift is printed, not held: the full-length
    soaks hold it), each leg's wall, card memory and RSS, the phase's
    seconds. It runs in the overfit proof's time, beside it (after 17's
    devaug ``--deterministic`` runs), so its times are not a clean card's;
17. scale-out (``scaleout_phase``) through ``--launcher pytorch``, each
    run 12 round-robin iterations of the flagship
    (``--steps-per-dispatch 1``): (a) ``tools/train.py`` on two ranks
    sharing the card under ``torch.distributed.run --nproc_per_node 2
    --standalone`` over gloo (NCCL refuses two ranks on one device; cls
    2x16x224^2, det 2x1x800^2, seg 2x2x512^2; the eval hook at 12 on both
    ranks) against a one-process twin on the same global batch
    (``samples_per_gpu`` doubled): per step the loss terms and grad_norm
    of ``metrics.jsonl`` (the ranks' shares summed by the log hook); each
    task's first step from the seed's weights (a one-step run per task)
    within the training-parity tolerances, and its gradients leaf by leaf
    (the first moment its ``iter_1.pth`` holds, ``(1 - b1)`` times the
    clipped gradient) within ``MU_RTOL`` / ``MU_ATOL``; the later steps
    printed; the plain 12-step run and a second one (``plain2``) with
    ``--deterministic`` (ROADMAP C17): every loss term and grad_norm of all
    12 steps bit-equal, and their ``iter_12.pth`` (weights and moments)
    bit-equal, every K1b / K2b launch on its ordered body; the two-rank
    ``iter_12.pth`` loaded into one process bit-equal to rank 0's
    gathered state; (b) one rank over NCCL, DP then FSDP
    (``parallel.fsdp=True``), against the plain one-process run; (c)
    two-rank FSDP over gloo (gloo carries FSDP2's all-gather and
    reduce-scatter of CUDA tensors: NVIDIA H100, torch 2.11) against the
    twin; (d) ``tools/test.py --launcher pytorch``
    on two ranks over (a)'s checkpoint against the one-process tool: the
    metrics and the seg label maps equal; (e) per rank and iteration the
    K1 / K1b / K2 / K2b launches (the one-process loop's, on the vector
    body), per-rank step and gradient-sum ms (CUDA events) and peak
    memory, labelled as two ranks sharing one card over gloo. Each rank
    runs this script's ``--scaleout-rank`` mode. The overfit proof (13b)
    starts in its own process once (a), (b) and (c) have ended, so the
    timed runs have the card and the host to themselves; then
    ``MTL_synthetic_flagship_devaug.py`` (the harness's training config,
    its augment stages on the card) through ``tools/train.py
    --deterministic`` twice for 6 round-robin iterations
    (``deterministic_devaug``): no op refuses the mode, every K1b / K2b
    launch on its ordered body, the two runs bit-equal at every step and
    in ``iter_6.pth``;
17b. the harness (``bench_phase``): ``python -m rscotr_tpu_torch.bench``
    in a process of its own (160 co-training iterations of
    ``MTL_synthetic_flagship_devaug.py``, then the root harness's
    inference fields): one stdout line with the root ``bench.py``'s keys,
    no ``train_bench_error``, 0 < mfu <= 1, the K1 / K2 launches per
    inference call the serving phase's (cls 0 / 12, det 12 / 12, seg 6 /
    12); the headline img/s and ``train_s_per_iter`` beside the card;
17c. the driver entry (``graft_phase``): ``graft_entry.entry()`` on the
    card (the paper MTL, bf16, det 256^2): 12 K1 launches a call on the
    vector body and 12 K2 on the tensor cores, the median of 20 calls
    (CUDA events); the same function in float32 on the card against the
    CPU (TF32 off): the encoder memory, the picked proposals' scores
    sorted, and the outputs where the top-k picks the same proposals,
    within ``GRAFT_TOL``; and ``python -m rscotr_tpu_torch.graft_entry 4``
    (``dryrun_multichip(4)``: four ranks sharing the card over gloo), run
    in its own session beside the overfit proof (started with it after the
    scale-out phase's timed runs, waited for after it): exit 0, every
    leg's line and ``OK``, its seconds (no scaling figure);
18. library yardsticks of K2 and K2b, last because cuDNN keeps workspace
    once it has run under graph capture: ``scaled_dot_product_attention``
    with the additive bias + mask, and its autograd backward, on the timed
    stages' own tensors (rebuilt from their seed), under every backend that
    takes them; the fastest is the yardstick. The port never calls it.

The line before the last is {"kernels": [...]}: nine kernels, each with
``launches`` (the main path's run: the flagship's training), K1, K1b, K2
and K2b also ``launches_paths`` (each zoo path's, each flagship task's,
the flagship eval's run, each tool's run in the tools phase, each
artifact request's, each loop step's per
task and the loop's whole run, the same for the first devaug and hostaug
runs, an ``entry()`` call's, a flagship cls and det step's with dropout,
counted from 0), ``max_abs_err``, ``ms`` and ``plain_ms``
(kernel and plain version, same inputs), ``bound_ms`` / ``bound_by`` (the
least time the card could take, computed from this run's tensors),
``library_ms`` / ``library`` (the one-call yardstick, null where there is
none; timed here, called nowhere in the port; for K2 and K2b the fastest
SDPA backend, named in ``library_backend``). K2 and K2b are shorter than
their wrapper's host time, so their ``ms`` and ``library_ms`` are device
times from a CUDA-graph replay, ``eager_ms`` is the eager-call time, and
``stages`` holds all three timed stage shapes. K1's ``ms`` is device time
too, at the det encoder with locations in [0, 1], beside ``eager_ms``,
``lane_ms`` (the lane body on the same tensors) and ``vec_launches`` /
``vec_launches_serving`` (the launches that took the vector body); its
``stages`` hold [-0.2, 1.2], det encoder B=4, seg encoder B=1 and B=4 and
the train decoder (Q=800). K1b's are device times too,
beside ``eager_ms``, ``whole_ms`` (the whole ``ms_deform_attn_bwd``: zero
fill, kernel, cast) and ``ordered_ms`` (its ordered body on the same
tensors, with ``ordered_parts``), timed at locations in [0, 1], as a
model's are; K1b's and K2b's ``ordered_launches_deterministic_steps`` are
those of the training phase's steps under the flag; K2b's ``ordered_ms``
is its ordered body on the same tensors; K2's and K2b's ``dropout_ms``
are their DROP bodies at p = ``dropout_p`` on the timed stage's tensors,
beside ``dropout_p0_ms``, the p = 0 bodies in the same turns; K1b's
``stages`` also hold the time at the [-0.2, 1.2] locations of the other
kernel cases, where half the corners are off the map and skipped. K4's and
K5's ``ms`` are device times too, beside ``eager_ms``, ``row_ms`` (the
warp-per-row body, the first kernel, on the same tensors) and
``vec_launches``; K4's ``library_ms`` is device time too. K3''s ``ms`` is
the device time of the launch alone, adding into a zeroed accumulator, at
locations in [0, 1], beside ``eager_ms``, ``whole_ms`` / ``whole_eager_ms``
(``scatter_add_mm`` with its zero fill), ``scalar_ms`` (the scalar body on
the same tensors), ``vec_launches`` and ``stages`` (also [-0.2, 1.2], where
about half the sampling points clamp onto edge cells); its ``library_ms``
is device time too. K7's ``ms`` and ``library_ms`` (``F.layer_norm``,
which writes f32) are device times from a graph replay beside
``eager_ms`` / ``library_eager_ms``, at the cls stage-1 norm, with the det
encoder's in ``stages``; its ``launches`` are the serving phase's (every
LayerNorm call of the five requests, ``launches_per_request``), and
``host_us`` holds the module's host cost with K7 and with its earlier
formula. The last line is {"ok": true, "device": {...}}. Without a CUDA
device the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TINY_CFG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
FLAGSHIP_CFG = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
PAPER_CFG = os.path.join(
    ROOT, "configs/multi/MTL_swin-t-p4-w7_1x1_resisc_dior_potsdam.py")
DINO_R50_CFG = os.path.join(ROOT,
                            "configs/det/dino_4scale_r50_1x1_50e_dior.py")
RSEG_R50_CFG = os.path.join(
    ROOT, "configs/seg/RSCoTrSeg_3scale_r50_512x512_80k_potsdam_IRRG_all.py")
# untimed calls before each zoo path's timed ones
ZOO_WARMUP = 2
# on-device augmentation: the flagship with all three augment tails on the
# card, and its twin with them on the host (PIL in the loader threads)
DEVAUG_CFG = os.path.join(ROOT,
                          "configs/multi/MTL_synthetic_flagship_devaug.py")
HOSTAUG_CFG = os.path.join(ROOT,
                           "configs/multi/MTL_synthetic_flagship_hostaug.py")
# an augment part on the card against the CPU, on the same inputs: at most
# this many uint8 levels, on at most this share of the values (the float32
# resample products sum in another order on each; a sin or tan of the
# rotation may differ in its last bit)
AUG_TOL = (1.0, 0.005)
# iterations of each devaug and hostaug run (steps_per_dispatch 16 as
# written: 16 cls, 16 det, 16 seg)
AUG_ITERS = 48
# the soak phase: iterations, its log and eval intervals (the full soak's
# 16 and 250 scaled to the run), and the seconds between phase 1's record
# at SOAK_EVAL or later and its SIGTERM (the step in flight then is past
# SOAK_EVAL)
SOAK_ITERS, SOAK_LOG, SOAK_EVAL = 96, 16, 48
SOAK_KILL_DELAY = 1.0
# the quad-gather path's kernels, which no model path launches
QUAD = ("K3'", "K4", "K5")

# K1 / K2 against the plain version on the same inputs. float32: kernel and
# plain differ only in summation order. bfloat16: the plain version runs in
# float32 on the same bf16-rounded inputs; the kernel, like the Pallas K1,
# keeps corner weights and sums in f32 and rounds once at the output, so the
# bound is one bf16 ulp of the result (2^-7 relative) plus 1e-3.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# backward kernels against the plain decomposition on the same inputs. The
# gradients are sums taken in another order (warp reductions, and f32
# atomics whose order changes from run to run), so the bound is scaled by
# the largest reference entry: |got - ref| <= atol * max|ref| + rtol * |ref|;
# bf16 outputs may differ by one bf16 ulp (2^-7 relative).
BTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7)}
# K2 / K2b in bf16 round P (and dS) to bf16 as operands of the tensor-core
# products, and so does the plain version. The two f32 values of an entry
# differ in their last bits (other summation order in the softmax), so where
# one lies on a rounding boundary the two bf16 operands differ by one bf16
# ulp, 2^-7 relative. That is rare, so of the n operand x factor terms that
# sum to one output at most P_FLIPS are taken to be off at once: on top of
# TOL / BTOL the bf16 comparisons allow P_FLIPS * P_ULP * max_j (|operand_ij|
# |factor_jd|) (``k2_ulp_slack``): the terms are P |v| for the output,
# P^T |dO| for dV, scale |dS| |k| for dQ and scale |dS|^T |q| for dK; nothing
# more for d_rel_bias (f32 dS) and nothing for f32 inputs, which round
# nowhere. The log line of each comparison gives the share of outputs that
# lie outside TOL / BTOL alone.
P_ULP = 2.0 ** -7
P_FLIPS = 2
# slice parity, CPU (plain versions) vs card (kernels), float32
SLICE_TOL = 1e-4
# training parity, CPU vs card, float32, TF32 off. The sums run in another
# order (cuBLAS, warp reductions, f32 atomics whose order changes from run
# to run), and Adam turns the float noise of a near-zero gradient element
# into an update of up to +-lr, so: loss terms and grad_norm per step at
# rtol 2e-3 / atol 2e-4; after the last step, at most 1e-3 of all parameter
# elements outside 2e-4 + 5e-3 * |w|, and none further than the most such
# sign flips can move an element, 2 * lr * steps = 8e-4 (tiny config, lr
# 1e-4, 4 steps). A composition bug (weight, avg factor, mask) moves whole
# tensors by O(lr * steps) and fails the first bound.
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
PARAM_ATOL, PARAM_RTOL, PARAM_FRAC, PARAM_MAX = 2e-4, 5e-3, 1e-3, 8e-4

# flagship shapes: det 800^2 and seg 512^2 encoder levels (strides 8..64)
# and Swin stages (maps padded to a multiple of the 7-wide window)
DET_SHAPES = ((100, 100), (50, 50), (25, 25), (13, 13))
SEG_SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))
# the paper MTL's cls encoder at 224^2 (levels low -> high resolution, the
# order the pixel decoders hand the encoder) and RSCoTrSeg-R50's 3-level
# encoder at 512^2
CLS_SHAPES = ((4, 4), (7, 7), (14, 14), (28, 28))
RSEG_SHAPES = ((16, 16), (32, 32), (64, 64))
K2_SHAPES = {  # name: (B, nW, H, shifted)
    "det800.s0": (1, 841, 3, True), "det800.s1": (1, 225, 6, True),
    "det800.s2": (1, 64, 12, True), "det800.s3": (1, 16, 24, True),
    "cls224.s0": (16, 64, 3, True), "cls224.s1": (16, 16, 6, True),
    "cls224.s2": (16, 4, 12, True), "cls224.s3": (16, 1, 24, False),
    "seg512.s0": (4, 361, 3, True), "seg512.s1": (4, 100, 6, True),
    "seg512.s2": (4, 25, 12, True), "seg512.s3": (4, 9, 24, True),
}


TIMED_K2 = ("det800.s0", "cls224.s0", "seg512.s0")

# published peaks of one H100 SXM, dense (NVIDIA's data sheet): device memory
# rate, bf16 tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "f32": 67e12}


def bound(tensors, flops: float, rate: str):
    """The least time the card could take: (ms, "bytes" or "operations").
    ``tensors`` are the call's inputs and outputs (or their size in bytes),
    each moved once at the device-memory rate; ``flops`` the operations
    these inputs need, at the published peak of ``rate``."""
    nbytes = tensors if isinstance(tensors, int) else sum(
        t.numel() * t.element_size() for t in tensors if t is not None)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[rate]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, the median over ``reps`` replays (CUDA events). Unlike
    ``cuda_ms`` the host's cost of issuing a call stays out of the number,
    which matters once a kernel is shorter than its wrapper's host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    graph.reset()   # hand the capture's memory pool back
    return float(np.median(times))


def check_close(name, got, ref, dtype, slack=None) -> float:
    atol, rtol = TOL[dtype]
    got = got.float()
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    over = err - rtol * ref.abs()
    excess = (over - (0 if slack is None else slack)).max().item()
    max_err = err.max().item()
    share = "" if slack is None else \
        f"; {(over > atol).float().mean().item():.1e} of outputs need P_FLIPS"
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err {max_err:.3e}  "
        f"(tol {atol:g} + {rtol:g}*|ref|{share})")
    if excess > atol:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max_abs_err {max_err:.3e})")
    return max_err


def timed_wa_inputs(name):
    """The bf16 inputs (and d_out) of a timed K2 / K2b stage, from a seed of
    their own: ``library_phase``, which runs last, rebuilds the same
    tensors for the library call."""
    B, nW, H, shifted = K2_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(100 + TIMED_K2.index(name))
    inputs = wa_inputs(B, nW, H, shifted, torch.bfloat16, g)
    d_out = torch.randn(inputs[0].shape, device="cuda",
                        generator=g).to(torch.bfloat16)
    return inputs + (d_out,)


def library_phase(times, btimes) -> None:
    """Fill ``library_ms`` of the timed K2 / K2b stages. It runs after every
    other phase: under graph capture cuDNN's SDPA keeps ~100 MiB of
    workspace allocated for good, which would otherwise sit in the peak
    memory that the serving and training phases report."""
    log("library phase: scaled_dot_product_attention on the timed K2 / K2b "
        "inputs")
    for name in TIMED_K2:
        fwd, bwd = sdpa_yardstick(name, *timed_wa_inputs(name))
        times[f"K2 {name}"].update(library_ms=fwd[0],
                                   library_backend=fwd[1])
        btimes[f"K2b {name}"].update(library_ms=bwd[0],
                                     library_backend=bwd[1])
    log_times({k: r for t in (times, btimes) for k, r in t.items()
               if k.startswith("K2")})


def k2_ulp_slack(q, k, v, bias, mask, scale, d_out=None, drop=None):
    """What P_FLIPS entries of P (and dS), one bf16 ulp off, may move the
    bf16 kernels' results by (see P_ULP): a tensor for the forward output,
    or, given ``d_out``, one per gradient (dq, dk, dv, d_rel_bias).
    ``drop`` (rate, seed): the attention dropout's, whose P' = P keep /
    (1 - p) is then the rounded operand of P' v and P'^T dO, and whose
    dP = (dO v^T) keep / (1 - p) enters dS."""
    from rscotr_tpu_torch.ops import philox
    from rscotr_tpu_torch.ops.window_attention import _probs

    def largest_term(operand, factor, over_rows=False):
        # operand (..., i, j), factor (..., j, d) -> max_j of the (i, d)
        # terms; ``over_rows``: factor (..., i, d) -> max_i of the (j, d)
        if over_rows:
            return (operand[..., None] * factor[..., :, None, :]).amax(-3)
        return (operand[..., None] * factor[..., None, :, :]).amax(-2)

    allow = P_FLIPS * P_ULP
    p = _probs(q, k, bias, mask, scale)
    m = None if drop is None else philox.keep_mask(
        p.shape, drop[0], drop[1], p.device).float() * \
        philox.keep_scale(drop[0])
    pd = p if m is None else p * m
    if d_out is None:
        return allow * largest_term(pd, v.float().abs())
    do = d_out.float()
    dp = torch.einsum("bwhqd,bwhkd->bwhqk", do, v.float())
    if m is not None:
        dp = dp * m
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).abs()
    return (allow * scale * largest_term(ds, k.float().abs()),
            allow * scale * largest_term(ds, q.float().abs(), True),
            allow * largest_term(pd, do.abs(), True), None)


def k2_cases():
    """(name, (B, nW, H, shifted), wa_inputs keywords) of every K2 / K2b
    comparison: the twelve flagship stage shapes, then q, k, v as strided
    views of the fused projection (head widths 32 and 64), 1,805 tiles per
    head, which the runs of windows per block (11 forward, 21 backward) do
    not divide, and a head width that takes the CUDA-core instantiation in
    bf16 too."""
    cases = [(name, shape, {}) for name, shape in K2_SHAPES.items()]
    cases.append(("fused-qkv views", (2, 9, 3, True), dict(fused_qkv=True)))
    cases.append(("fused-qkv hd=64", (2, 9, 3, True),
                  dict(fused_qkv=True, hd=64)))
    cases.append(("ragged 5x361", (5, 361, 3, True), dict(fused_qkv=True)))
    cases.append(("cuda-core hd=24", (2, 9, 3, True), dict(hd=24)))
    return cases


# the earlier bodies of K1, K4, K5 and K3', timed on the same tensors
OLD_BODIES = {"lane_ms": "lane body", "row_ms": "warp-per-row body",
              "scalar_ms": "scalar body"}


def log_times(times) -> None:
    for name, r in times.items():
        lib = r.get("library_ms")
        via = f" ({r['library_backend']})" if "library_backend" in r else ""
        eager = f" (eager {r['eager_ms']:.4f})" if "eager_ms" in r else ""
        for key, body in OLD_BODIES.items():
            if key in r:
                eager += f"; {body} {r[key]:.4f} ms"
        if "whole_ms" in r:
            eager += (f"; whole wrapper {r['whole_ms']:.4f} ms "
                      f"(eager {r['whole_eager_ms']:.4f})")
        log(f"  time bf16 {name:<28} kernel {r['ms']:.4f} ms{eager}   plain "
            f"{r['plain_ms']:.4f} ms   bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})   library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}{via}")


def msda_inputs(B, Q, dtype, g, H=8, D=32, P=4, shapes=DET_SHAPES,
                span=(-0.2, 1.2)):
    L = len(shapes)
    Nv = sum(h * w for h, w in shapes)
    v = torch.randn(B, Nv, H, D, device="cuda", generator=g).to(dtype)
    # locations straddle the border to exercise the validity masking
    loc = torch.rand(B, Q, H, L, P, 2, device="cuda", generator=g) * (
        span[1] - span[0]) + span[0]
    w = torch.rand(B, Q, H, L, P, device="cuda", generator=g)
    w = (w / w.sum((-1, -2), keepdim=True)).to(dtype)
    return v, shapes, loc, w


def wa_inputs(B, nW, H, shifted, dtype, g, n=49, hd=32, fused_qkv=False):
    """``fused_qkv``: q, k, v as the strided views of one (B * nW, n, 3 * H
    * hd) projection that the Swin block passes (swin.py, WindowMSA)."""
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    if fused_qkv:
        qkv = torch.randn(B * nW, n, 3, H, hd, device="cuda",
                          generator=g).to(dtype).permute(2, 0, 3, 1, 4)
        q, k, v = (t.unflatten(0, (B, nW)) for t in qkv.unbind(0))
    else:
        q, k, v = (torch.randn(B, nW, H, n, hd, device="cuda",
                               generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(H, n, n, device="cuda", generator=g) * 0.02
    mask = None
    if shifted:
        side = int(round(nW ** 0.5)) * 7
        mask = torch.as_tensor(_shift_attn_mask(side, side, 7, 3),
                               device="cuda")
    return q, k, v, bias, mask, hd ** -0.5


def sdpa_yardstick(name, q, k, v, bias, mask, scale, d_out):
    """The library yardstick of K2 and K2b: one
    ``F.scaled_dot_product_attention`` call (and its autograd backward for
    q, k, v) on the same inputs, under every backend that takes them; the
    additive ``bias[h] + mask[w]`` is built once in q's dtype outside the
    timed region, its last axis padded to a multiple of 8 in memory for the
    fused backends. Device time by ``graph_ms``, as the kernels'. Timed
    here only: the port never calls it. Returns the fastest of each as
    ((forward ms, backend), (backward ms, backend))."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from rscotr_tpu_torch.ops.window_attention import window_attention_torch
    B, nW, H, n, hd = q.shape
    add = bias[None, None]
    if mask is not None:
        add = add + mask[None, :, None]
    buf = torch.zeros(B * nW, H, n, -(-n // 8) * 8, dtype=q.dtype,
                      device=q.device)
    buf[..., :n] = add.expand(B, nW, H, n, n).reshape(B * nW, H, n, n)
    attn = buf[..., :n]
    qq, kk, vv = (t.detach().reshape(B * nW, H, n, hd).contiguous()
                  .requires_grad_() for t in (q, k, v))
    do = d_out.reshape(qq.shape)
    ref = window_attention_torch(q.float(), k.float(), v.float(), bias, mask,
                                 scale)

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn,
                                              scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    fwd_ms, bwd_ms = {}, {}
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.MATH):
        # a backend that does not take these inputs raises: reported, not
        # timed (this is a yardstick, no path of the port)
        try:
            with sdpa_kernel(backend):
                with torch.no_grad():
                    e = (fwd().float().reshape(ref.shape) - ref).abs().max(
                        ).item()
                    f_ms = graph_ms(fwd)
                # the backward alone: forward + backward less the forward
                # (in grad mode), each captured whole so that both run on
                # the capture's stream
                b_ms = graph_ms(fwd_bwd) - graph_ms(fwd)
        except RuntimeError:
            log(f"  library {name:<12} SDPA {backend.name} refused the "
                "inputs")
            continue
        if not e < 5e-2:
            fail(f"SDPA yardstick {name} {backend.name}: not the same "
                 f"function (max abs diff {e:.3e} from the plain version)")
        fwd_ms[backend.name], bwd_ms[backend.name] = f_ms, b_ms
        log(f"  library {name:<12} SDPA {backend.name:<20} forward "
            f"{fwd_ms[backend.name]:.4f} ms, backward (dq, dk, dv; no bias "
            f"gradient) {bwd_ms[backend.name]:.4f} ms; max abs diff from "
            f"plain {e:.2e}")
    best = [min((ms, b) for b, ms in t.items()) for t in (fwd_ms, bwd_ms)]
    log(f"  library {name:<12} fastest: forward {best[0][1]} "
        f"{best[0][0]:.4f} ms, backward {best[1][1]} {best[1][0]:.4f} ms")
    return best


def index_add_yardstick(d_g, gidx, num_rows, want):
    """The library yardstick of K3': one bare ``index_add_`` of the f32
    updates into the f32 (G * num_rows + 1, C) table (the spare row takes
    the out-of-range updates, which K3' drops; cast, index arithmetic and
    zeroing are outside the timed region). Device time by ``graph_ms``, as
    the kernel's. Timed here only."""
    G, K, C = d_g.shape
    src = d_g.float().reshape(G * K, C)
    idx = gidx.long()
    valid = (idx >= 0) & (idx < num_rows)
    base = torch.arange(G, device=d_g.device)[:, None] * num_rows
    flat = torch.where(valid, idx + base, G * num_rows).reshape(-1)
    out = torch.zeros(G * num_rows + 1, C, device=d_g.device)
    out.index_add_(0, flat, src)
    e = (out[:-1].reshape(want.shape) - want).abs().max().item()
    if not e <= 1e-4 * want.abs().max().item():
        fail(f"index_add_ yardstick: not the same function ({e:.3e})")
    ms = graph_ms(lambda: out.index_add_(0, flat, src))
    log(f"  library K3' index_add_ of f32 (G*K, C) = ({G * K}, {C}) into "
        f"({G * num_rows + 1}, {C}): {ms:.4f} ms")
    return ms


def bmm_yardstick(gq, wt, want):
    """The library yardstick of K4: one ``torch.bmm`` of the weights in
    k-major order, (R, 1, 4 KP), by g's rows as (R, 4 KP, D), R = G Q (a
    row of g is (KP, 4, D) contiguous; the reorder of the weights is outside
    the timed call), with a float32 output where the installed torch's bmm
    takes ``out_dtype``, else in g's dtype. Device time by ``graph_ms``, as
    the kernel's. Timed here only: (ms, what was called)."""
    G, Q, KP, C4 = gq.shape
    R, D = G * Q, C4 // 4
    a = wt.view(R, 4, KP).transpose(1, 2).reshape(R, 1, 4 * KP)
    b = gq.view(R, 4 * KP, D)
    lib = "torch.bmm(wt k-major (R, 1, 4 KP), g (R, 4 KP, D)"
    try:
        got = torch.bmm(a, b, out_dtype=torch.float32)
        lib += ", out_dtype=torch.float32)"

        def call():
            return torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        got = torch.bmm(a, b)
        lib += f") with a {str(gq.dtype)[6:]} output: this torch's bmm " \
               "takes no out_dtype"

        def call():
            return torch.bmm(a, b)
    check_close("library K4 torch.bmm", got.view(G, Q, D), want, gq.dtype)
    ms = graph_ms(call)
    log(f"  library K4 {lib}: {ms:.4f} ms")
    return ms, lib


def corners_on_map(shapes, loc) -> int:
    """How many of the sampling points' 4 x points bilinear corners lie on
    their level's map: the corner rows K1 and K1b load."""
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=loc.device)[:, None]
    x0 = torch.floor(loc * wh - 0.5)                  # (B, Q, H, L, P, 2)
    on = [((x0 + d >= 0) & (x0 + d < wh)).long() for d in (0, 1)]
    return int(sum((on[dy][..., 1] * on[dx][..., 0]).sum()
                   for dy in (0, 1) for dx in (0, 1)))


# K1 cases: name -> (B, Q, levels, location span, timed). The timed cases
# use a model's locations, [0, 1], where nearly every corner is on the map;
# the det encoder is also timed at [-0.2, 1.2], the span of the first
# kernel's earlier times, where about half the corners are off the map and
# skipped.
K1_SPAN = (-0.2, 1.2)
K1_CASES = {
    "det-encoder B=1 loc in [0, 1]": (1, None, DET_SHAPES, (0.0, 1.0), True),
    "det-encoder B=1": (1, None, DET_SHAPES, K1_SPAN, True),
    "det-encoder B=4 loc in [0, 1]": (4, None, DET_SHAPES, (0.0, 1.0), True),
    "det-encoder B=4": (4, None, DET_SHAPES, K1_SPAN, False),
    "decoder B=1 Q=600": (1, 600, DET_SHAPES, K1_SPAN, False),
    "train decoder B=1 Q=800 loc in [0, 1]": (1, 800, DET_SHAPES, (0.0, 1.0),
                                              True),
    "seg-encoder B=1 loc in [0, 1]": (1, None, SEG_SHAPES, (0.0, 1.0), True),
    "seg-encoder B=1": (1, None, SEG_SHAPES, K1_SPAN, False),
    "seg-encoder B=4 loc in [0, 1]": (4, None, SEG_SHAPES, (0.0, 1.0), True),
    "seg-encoder B=4": (4, None, SEG_SHAPES, K1_SPAN, False),
    "paper cls-encoder B=16": (16, None, CLS_SHAPES, K1_SPAN, False),
    "RSCoTrSeg-R50 encoder B=2 L=3": (2, None, RSEG_SHAPES, K1_SPAN, False),
}
K1_HEADLINE = "det-encoder B=1 loc in [0, 1]"


def k1_phase(err, times):
    """K1 against its plain version at the flagship's shapes, both bodies
    on the same tensors: the vector body (what ``msda_fwd_body`` picks, and
    every model-path launch takes) and the lane-per-channel body (the
    parent's kernel, ``body=BODY_LANE``). The timed cases give device times
    of both by graph replay, the eager time, the plain version's, the bound
    and the modelled L2 traffic."""
    from rscotr_tpu_torch.ops import flops
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        BODY_LANE, BODY_VEC, _ms_deform_attn_cuda, ms_deform_attn,
        ms_deform_attn_torch, msda_fwd_body)
    g = torch.Generator(device="cuda").manual_seed(0)
    log("kernel phase: K1 msda_fwd, vector and lane bodies, vs "
        "ms_deform_attn_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, Q, lvls, span, timed) in K1_CASES.items():
            Q = Q or sum(h * w for h, w in lvls)
            v, shapes, loc, w = msda_inputs(B, Q, dtype, g, shapes=lvls,
                                            span=span)
            if msda_fwd_body(v.shape[-1], [v.data_ptr(), loc.data_ptr()]) \
                    != BODY_VEC:
                fail(f"K1 {name}: the case does not take the vector body")
            before = (ms_deform_attn.launches, ms_deform_attn.vec_launches)
            got = ms_deform_attn(v, shapes, loc, w)
            lane = _ms_deform_attn_cuda(v, shapes, loc, w, body=BODY_LANE)
            torch.cuda.synchronize()
            if (ms_deform_attn.launches, ms_deform_attn.vec_launches) != \
                    (before[0] + 2, before[1] + 1):
                fail(f"K1 {name}: not one vector and one lane launch")
            ref = ms_deform_attn_torch(v.float(), shapes, loc, w.float())
            e = check_close(f"K1 {name}", got, ref, dtype)
            check_close(f"K1 {name} (lane body)", lane, ref, dtype)
            err["K1"][bf] = max(err["K1"][bf], e)
            if not (timed and bf):
                continue
            D = v.shape[-1]
            on_map = corners_on_map(shapes, loc)
            # one multiply-add per channel of each corner on the map
            ms, by = bound((v, loc, w, got), flops.msda_fwd_flops(on_map, D),
                           "f32")

            def vec():
                return ms_deform_attn(v, shapes, loc, w)

            def lane_body():
                return _ms_deform_attn_cuda(v, shapes, loc, w,
                                            body=BODY_LANE)

            times[f"K1 {name}"] = dict(
                ms=graph_ms(vec), eager_ms=cuda_ms(vec, 50),
                lane_ms=graph_ms(lane_body),
                plain_ms=cuda_ms(
                    lambda: ms_deform_attn_torch(v, shapes, loc, w), 10),
                bound_ms=ms, bound_by=by, library_ms=None)
            # a model of the L2 traffic, not a reading: one row load per
            # corner on the map
            rows = on_map * D * v.element_size()
            rate = rows / 1e9 / times[f"K1 {name}"]["ms"]
            log(f"  K1 {name}: {on_map} corners on the map, {rows / 1e6:.1f}"
                " MB of corner rows from L2 (modelled from the corner count,"
                f" no counter read): {rate:.2f} TB/s over the vector body's "
                "time")


def kernel_phase():
    from rscotr_tpu_torch.ops import flops
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}   # [f32, bf16]
    times = {}
    k1_phase(err, times)
    log("kernel phase: K2 window_attn vs window_attention_torch (the plain "
        "version at the kernel's dtype: for bf16 it rounds P where the "
        "kernel does)")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, nW, H, shifted), kw in k2_cases():
            for masked in sorted({False, shifted}):
                timed = bool(bf and masked == shifted and name in TIMED_K2)
                if timed:
                    q, k, v, bias, mask, scale, _ = timed_wa_inputs(name)
                else:
                    q, k, v, bias, mask, scale = wa_inputs(
                        B, nW, H, masked, dtype, g, **kw)
                before = window_attention.launches
                got = window_attention(q, k, v, bias, mask, scale)
                torch.cuda.synchronize()
                if window_attention.launches != before + 1:
                    fail(f"K2 {name}: the wrapper counted no launch")
                ref = window_attention_torch(q, k, v, bias, mask, scale)
                e = check_close(
                    f"K2 {name} {'masked' if masked else ''}", got,
                    ref.float(), dtype,
                    k2_ulp_slack(q, k, v, bias, mask, scale) if bf else None)
                err["K2"][bf] = max(err["K2"][bf], e)
                if timed:
                    n, hd = q.shape[-2:]
                    tiles = B * nW * H
                    ms, by = bound((q, k, v, bias, mask, got),
                                   flops.window_attn_flops(tiles, n, hd),
                                   "bf16 tensor")
                    def run():
                        return window_attention(q, k, v, bias, mask, scale)

                    # ms: device time (graph replay), as library_ms; the
                    # kernel is shorter than its wrapper's host time, which
                    # eager_ms (events around eager calls) includes
                    times[f"K2 {name}"] = dict(
                        ms=graph_ms(run), eager_ms=cuda_ms(run, 50),
                        plain_ms=cuda_ms(lambda: window_attention_torch(
                            q, k, v, bias, mask, scale), 20),
                        bound_ms=ms, bound_by=by, library_ms=None)
    log_times(times)
    return err, times


# K2's long-window body at Swin-L's stages (window 12, n = 144, head width
# 32) on 16 tiles of 640^2: (B, nW, H, side of the padded map)
K2_LONG_SHAPES = {
    "swinl640.s0": (16, 196, 6, 168), "swinl640.s1": (16, 49, 12, 84),
    "swinl640.s2": (16, 16, 24, 48), "swinl640.s3": (16, 4, 48, 24),
}
K2_LONG_WINDOW = 12


def long_wa_inputs(B, nW, H, side, masked, seed, window=K2_LONG_WINDOW,
                   hd=32):
    """bf16 q, k, v as the strided views of one fused projection (as the
    Swin block passes them), the f32 bias and, ``masked``, the shift mask
    of a ``side`` x ``side`` map."""
    from rscotr_tpu_torch.models.backbones.swin import _shift_attn_mask
    n = window * window
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B * nW, n, 3, H, hd, device="cuda",
                      generator=g).to(torch.bfloat16).permute(2, 0, 3, 1, 4)
    q, k, v = (t.unflatten(0, (B, nW)) for t in qkv.unbind(0))
    bias = torch.randn(H, n, n, device="cuda", generator=g) * 0.02
    mask = torch.as_tensor(_shift_attn_mask(side, side, window, window // 2),
                           device="cuda") if masked else None
    return q, k, v, bias, mask, hd ** -0.5


def k2_long_phase():
    """K2's long-window tensor-core body (``tc144_launches``) against the
    plain version, image by image within the two-flip allowance, and timed
    beside the CUDA-core body on the same tensors, at Swin-L's four stage
    shapes, unshifted and shifted; then windows 9 to 11 (n = 81, 100, 121,
    padded rows and keys) and attention dropout, checked."""
    from rscotr_tpu_torch.ops import flops
    from rscotr_tpu_torch.ops import window_attention as wa
    log("K2 long-window phase: window_attn_tc144_kernel vs "
        "window_attention_torch and the CUDA-core body (run=0)")
    times, seed = {}, 300

    def check(name, q, k, v, bias, mask, scale, got, drop=None):
        excess = worst = 0.0
        atol, rtol = TOL[torch.bfloat16]
        # image by image, to bound the allowance's memory; with dropout
        # whole, since the keep bits follow the tile's index in the batch
        parts = [slice(None)] if drop else \
            [slice(b, b + 1) for b in range(q.shape[0])]
        for b in parts:
            one = (q[b], k[b], v[b], bias, mask, scale)
            ref = wa.window_attention_torch(*one, *(drop or ())).float()
            err = (got[b].float() - ref).abs()
            slack = k2_ulp_slack(*one, drop=drop)
            excess = max(excess, (err - rtol * ref.abs() - slack).max().item())
            worst = max(worst, err.max().item())
        log(f"  {name:<34} bf16     max_abs_err {worst:.3e}  (tol {atol:g} "
            f"+ {rtol:g}*|ref| + P_FLIPS)")
        if not torch.isfinite(got).all() or excess > atol:
            fail(f"{name}: the long-window body disagrees with its plain "
                 f"version (max_abs_err {worst:.3e})")

    for name, (B, nW, H, side) in K2_LONG_SHAPES.items():
        for masked in (False, True):
            seed += 1
            q, k, v, bias, mask, scale = long_wa_inputs(B, nW, H, side,
                                                        masked, seed)
            before = (wa.window_attention.launches,
                      wa.window_attention.tc144_launches)
            got = wa.window_attention(q, k, v, bias, mask, scale)
            torch.cuda.synchronize()
            if (wa.window_attention.launches - before[0],
                    wa.window_attention.tc144_launches - before[1]) != (1, 1):
                fail(f"K2 {name}: not one long-window launch")
            label = f"K2 {name}{' masked' if masked else ''}"
            check(label, q, k, v, bias, mask, scale, got)
            core = wa._window_attention_cuda(q, k, v, bias, mask, scale,
                                             run=0)
            check(label + " (cuda-core)", q, k, v, bias, mask, scale, core)
            n, hd = q.shape[-2:]
            ms, by = bound((q, k, v, bias, mask, got),
                           flops.window_attn_flops(B * nW * H, n, hd),
                           "bf16 tensor")
            times[label] = dict(
                ms=graph_ms(lambda: wa.window_attention(q, k, v, bias, mask,
                                                        scale)),
                core_ms=graph_ms(lambda: wa._window_attention_cuda(
                    q, k, v, bias, mask, scale, run=0), iters=5, reps=3),
                plain_ms=cuda_ms(lambda: wa.window_attention_torch(
                    q[:1], k[:1], v[:1], bias, mask, scale), 5) * B,
                bound_ms=ms, bound_by=by)
            del q, k, v, got, core
            torch.cuda.empty_cache()
    for window in (9, 10, 11):
        for masked in (False, True):
            seed += 1
            side = 4 * window
            q, k, v, bias, mask, scale = long_wa_inputs(
                3, 16, 5, side, masked, seed, window)
            before = wa.window_attention.tc144_launches
            got = wa.window_attention(q, k, v, bias, mask, scale)
            if wa.window_attention.tc144_launches != before + 1:
                fail(f"K2 window {window}: not a long-window launch")
            check(f"K2 window {window}{' masked' if masked else ''}", q, k,
                  v, bias, mask, scale, got)
    q, k, v, bias, mask, scale = long_wa_inputs(2, 16, 6, 48, True, seed + 1)
    drop = (0.3, 12345)
    got = wa.window_attention(q, k, v, bias, mask, scale, *drop)
    check("K2 window 12 dropout 0.3", q, k, v, bias, mask, scale, got, drop)
    for label, r in times.items():
        log(f"  time bf16 {label:<28} kernel {r['ms']:.4f} ms   cuda-core "
            f"body {r['core_ms']:.4f} ms ({r['core_ms'] / r['ms']:.1f}x)   "
            f"plain {r['plain_ms']:.4f} ms   bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it)")
    log(f"  tc144_launches {wa.window_attention.tc144_launches}")
    return times


# K7 (LayerNorm forward) at the main path's shapes: (rows, C, input dtype,
# output dtype). The cls stage-1 block norm (256 x 56^2 rows, f32 in, bf16
# out to the qkv product) and the det encoder's norm (16 x 13,294 rows, f32
# in and out) are timed; the others are checked.
K7_CASES = {
    "cls224.s0 norm1": (802816, 96, torch.float32, torch.bfloat16),
    "det encoder norm": (212704, 256, torch.float32, torch.float32),
    "cls224 patch embed": (802816, 96, torch.bfloat16, torch.float32),
    "cls224.s1 norm1": (200704, 192, torch.float32, torch.bfloat16),
    "cls224 merge 4C=1536": (12544, 1536, torch.float32, torch.bfloat16),
    "cls224.s3 out norm": (12544, 768, torch.float32, torch.float32),
    "det decoder norm": (9600, 256, torch.float32, torch.float32),
    "ragged 7 rows": (7, 96, torch.float32, torch.bfloat16),
}
TIMED_K7 = ("cls224.s0 norm1", "det encoder norm")
# host cost of a LayerNorm call: calls a timed loop issues, at the decoder's
# shape, where the host paces the request
K7_HOST_CALLS = 2000


def k7_inputs(rows, C, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, C, device="cuda", generator=g) * 3
         + torch.randn(rows, 1, device="cuda", generator=g)).to(dtype)
    w = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    return x, w, b


def k7_check(name, got, ref) -> float:
    """f32 outputs at TOL's f32 bound; bf16 outputs within one bf16 ulp of
    the plain version's (two f32 results a few ulps apart round to
    neighbouring bf16 values where they straddle a rounding boundary) plus
    that f32 bound (an output near 0 is the difference of the affine
    terms, whose f32 rounding error exceeds its bf16 ulp)."""
    if not torch.isfinite(got.float()).all():
        fail(f"K7 {name}: non-finite output")
    err = (got.float() - ref.float()).abs()
    atol, rtol = TOL[torch.float32]
    allow = atol + rtol * ref.float().abs()
    tol = f"tol {atol:g} + {rtol:g}*|ref|"
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(ref.float())
        allow = allow + torch.ldexp(torch.ones_like(err), e - 8)
        tol += " + one bf16 ulp of the plain version's"
    ok = bool((err <= allow).all())
    log(f"  K7 {name:<24} {str(got.dtype)[6:]:<8} max_abs_err "
        f"{err.max().item():.3e}  ({tol})")
    if not ok:
        fail(f"K7 {name}: kernel disagrees with its plain version")
    return err.max().item()


def k7_host_us(fn, calls=K7_HOST_CALLS) -> float:
    """Host microseconds a call: ``calls`` calls issued in a loop, no
    synchronisation inside it (the card runs behind the host)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def layer_norm_phase():
    """K7 against its plain version, timed beside its bound, the plain
    version and ``F.layer_norm`` (the library call the port made before
    K7); then the host cost of a ``LayerNorm`` module call with K7 against
    the module's earlier formula ``F.layer_norm(x.float(), ...)``."""
    import torch.nn.functional as F

    from rscotr_tpu_torch.models.layers.common import LayerNorm, init_weights
    from rscotr_tpu_torch.ops.layer_norm import layer_norm, layer_norm_torch
    log("layer norm phase: K7 layer_norm_fwd vs layer_norm_torch (the plain "
        "version in float32, cast to the output dtype)")
    err, times = [0.0, 0.0], {}
    for i, (name, (rows, C, dt, out)) in enumerate(K7_CASES.items()):
        x, w, b = k7_inputs(rows, C, dt, 200 + i)
        before = layer_norm.launches
        got = layer_norm(x, w, b, 1e-5, out)
        torch.cuda.synchronize()
        if layer_norm.launches != before + 1:
            fail(f"K7 {name}: the wrapper counted no launch")
        e = k7_check(name, got, layer_norm_torch(x, w, b, 1e-5, out))
        bf = int(out == torch.bfloat16)
        err[bf] = max(err[bf], e)
        if name not in TIMED_K7:
            continue

        def run():
            return layer_norm(x, w, b, 1e-5, out)

        def library():
            return F.layer_norm(x, (C,), w, b, 1e-5)

        ms, by = bound((x, w, b, got), 8.0 * rows * C, "f32")
        times[f"K7 {name}"] = dict(
            ms=graph_ms(run), eager_ms=cuda_ms(run, 50),
            plain_ms=cuda_ms(lambda: layer_norm_torch(x, w, b, 1e-5, out),
                             10),
            bound_ms=ms, bound_by=by, library_ms=graph_ms(library),
            library_eager_ms=cuda_ms(library, 50),
            timed_at=f"({rows}, {C}) {str(dt)[6:]} in, {str(out)[6:]} out")
        del x, got
    log_times(times)

    # host cost: a module call under inference_mode, K7 against a twin
    # module whose forward is the earlier formula, in turns, at the
    # decoder's shape and the patch embedding's bf16 input (the cast the
    # earlier formula issued on top); and the wrapper alone
    def earlier(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)

    host = {}
    for name, (rows, C, dt) in {
            "det decoder (9600, 256) f32": (9600, 256, torch.float32),
            "patch embed (4096, 96) bf16": (4096, 96, torch.bfloat16)
    }.items():
        m, twin = LayerNorm(C).cuda(), LayerNorm(C).cuda()
        init_weights(m, torch.Generator())
        init_weights(twin, torch.Generator())
        twin.forward = types.MethodType(earlier, twin)
        x = k7_inputs(rows, C, dt, 300)[0]
        k7, old, bare = [], [], []
        with torch.inference_mode():
            for _ in range(3):
                k7.append(k7_host_us(lambda: m(x)))
                old.append(k7_host_us(lambda: twin(x)))
                bare.append(k7_host_us(lambda: layer_norm(x, m.weight,
                                                          m.bias)))
        host[name] = dict(k7_us=float(np.median(k7)),
                          earlier_us=float(np.median(old)),
                          wrapper_us=float(np.median(bare)))
        log(f"  host cost of a LayerNorm module call, {name}: K7 "
            + " / ".join(f"{v:.2f}" for v in k7) + " us, earlier formula "
            + " / ".join(f"{v:.2f}" for v in old) + " us; the wrapper "
            "alone " + " / ".join(f"{v:.2f}" for v in bare) + " us (3 "
            f"turns of {K7_HOST_CALLS} calls)")
    return err, times, host


def quad_phase():
    """K4 / K5 and the quad-gather MSDA at the det encoder: the main path's
    run (``impl="quad"`` forward + backward, bf16, which also launches K3',
    the value-gradient scatter of this path; K4, K5 and K3' must take their
    vector bodies), K4 / K5 against their plain versions (both bodies of
    each), the quad path against the K1 path, times (K4 also its library
    yardstick) and peak memory."""
    from rscotr_tpu_torch.ops.kernel_lib import BODY_LANE
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.msda_ws import (_ws_bwd_cuda, _ws_fwd_cuda,
                                              ws_bwd, ws_bwd_torch, ws_fwd,
                                              ws_fwd_torch)
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    g = torch.Generator(device="cuda").manual_seed(2)
    Nv = sum(h * w for h, w in DET_SHAPES)
    G, KP, D = 8, 16, 32
    log("quad phase: ms_deform_attn(impl=\"quad\") at the det encoder B=1 "
        "Q=Nv=13294 H=8 L=4 P=4 D=32")
    # -- the main path's run: one quad forward + backward, bf16 ----------
    v, shapes, loc, w = msda_inputs(1, Nv, torch.bfloat16, g)
    leaves = tuple(t.requires_grad_() for t in (v, loc, w))
    d_out = torch.randn(1, Nv, 8 * D, device="cuda",
                        generator=g).to(torch.bfloat16)
    for fn in (ws_fwd, ws_bwd, scatter_add_mm):
        fn.launches = 0
    ws_fwd.vec_launches = ws_bwd.vec_launches = 0
    scatter_add_mm.vec_launches = 0
    out = ms_deform_attn(v, shapes, loc, w, impl="quad")
    grads = torch.autograd.grad(out, leaves, d_out)
    torch.cuda.synchronize()
    launches = {"K4": ws_fwd.launches, "K5": ws_bwd.launches,
                "K3'": scatter_add_mm.launches,
                "K4 vec": ws_fwd.vec_launches,
                "K5 vec": ws_bwd.vec_launches,
                "K3' vec": scatter_add_mm.vec_launches}
    log(f"  launches in the main path's run: {launches} (want 1 each: K4, "
        "K5 and K3' on their vector bodies)")
    if set(launches.values()) != {1}:
        fail(f"quad path: kernel launches {launches} != 1 each")
    if not (torch.isfinite(out).all() and
            all(torch.isfinite(t).all() for t in grads)):
        fail("quad path: non-finite output or gradient")
    del out, grads

    log("quad phase: K4 ws_fwd vs ws_fwd_torch, K5 ws_bwd vs ws_bwd_torch "
        "at g (8, 13294, 16, 128)")
    err = {"K4": [0.0, 0.0], "K5": [0.0, 0.0]}   # [f32, bf16]
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        gq = torch.randn(G, Nv, KP, 4 * D, device="cuda",
                         generator=g).to(dtype)
        # the quad path hands K4 / K5 its slot weights in value's dtype
        wt = torch.rand(G, Nv, 4 * KP, device="cuda", generator=g).to(dtype)
        dq = torch.randn(G, Nv, D, device="cuda", generator=g)
        vec = ws_fwd.vec_launches
        k4_out = ws_fwd(gq, wt)
        k4_row = _ws_fwd_cuda(gq, wt, body=BODY_LANE)
        torch.cuda.synchronize()
        if ws_fwd.vec_launches != vec + 1:
            fail("K4 det-encoder: not one launch on the vector body")
        k4_ref = ws_fwd_torch(gq, wt)
        err["K4"][bf] = check_close("K4 det-encoder", k4_out, k4_ref, dtype)
        check_close("K4 det-encoder (warp-per-row body)", k4_row, k4_ref,
                    dtype)
        del k4_row
        vec = ws_bwd.vec_launches
        got = ws_bwd(gq, wt, dq)
        row = _ws_bwd_cuda(gq, wt, dq, body=BODY_LANE)
        torch.cuda.synchronize()
        if ws_bwd.vec_launches != vec + 1:
            fail("K5 det-encoder: not one launch on the vector body")
        ref = ws_bwd_torch(gq, wt, dq)
        # d_g is one f32 product rounded once to g's dtype on both sides
        if not (torch.equal(got[0], ref[0]) and torch.equal(row[0], ref[0])):
            fail("K5 d_g differs from its plain version")
        err["K5"][bf] = check_grads("K5 det-encoder", got, ref,
                                    ("d_g", "d_wt"), dtype)
        check_grads("K5 det-encoder (warp-per-row body)", row, ref,
                    ("d_g", "d_wt"), dtype)
        del row
        if bf:
            # K4: one multiply-add per element of g; K5: one product for
            # d_g and one multiply-add for d_wt per element of g
            # ms: device time (graph replay); eager_ms: events around eager
            # calls, the wrapper's host time included
            ms, by = bound((gq, wt, k4_out), 2.0 * gq.numel(), "f32")
            lib_ms, lib = bmm_yardstick(gq, wt, k4_ref)
            times["K4 det-encoder"] = dict(
                ms=graph_ms(lambda: ws_fwd(gq, wt)),
                eager_ms=cuda_ms(lambda: ws_fwd(gq, wt), 50),
                row_ms=graph_ms(lambda: _ws_fwd_cuda(gq, wt,
                                                     body=BODY_LANE)),
                plain_ms=cuda_ms(lambda: ws_fwd_torch(gq, wt), 10),
                bound_ms=ms, bound_by=by, library_ms=lib_ms, library=lib)
            ms, by = bound((gq, wt, dq) + tuple(got), 3.0 * gq.numel(),
                           "f32")
            times["K5 det-encoder"] = dict(
                ms=graph_ms(lambda: ws_bwd(gq, wt, dq)),
                eager_ms=cuda_ms(lambda: ws_bwd(gq, wt, dq), 50),
                row_ms=graph_ms(lambda: _ws_bwd_cuda(gq, wt, dq,
                                                     body=BODY_LANE)),
                plain_ms=cuda_ms(lambda: ws_bwd_torch(gq, wt, dq), 10),
                bound_ms=ms, bound_by=by, library_ms=None)
        del got, ref, k4_out, k4_ref, gq, wt, dq

    # f32: the two paths sum in other orders (BTOL); bf16: the quad path
    # rounds its slot weights to bf16 before K4 (as JAX's
    # _ms_deform_attn_xla) and d_wt back to bf16 after K5, the K1 path keeps
    # corner weights in f32, and both round the output: two bf16 ulps of the
    # largest entry
    log("quad phase: impl=\"quad\" vs impl=\"kernel\" (K1, K1b), "
        "forward and torch.autograd.grad")
    qtol = {torch.float32: BTOL[torch.float32], torch.bfloat16: (2.0 ** -6,
                                                                 0.0)}
    for dtype in (torch.float32, torch.bfloat16):
        v, shapes, loc, w = msda_inputs(1, Nv, dtype, g)
        leaves = tuple(t.requires_grad_() for t in (v, loc, w))
        d_out = torch.randn(1, Nv, 8 * D, device="cuda", generator=g).to(dtype)
        res = {}
        for impl in ("quad", "kernel"):
            o = ms_deform_attn(v, shapes, loc, w, impl=impl)
            res[impl] = (o.detach(),) + torch.autograd.grad(o, leaves, d_out)
        torch.cuda.synchronize()
        check_grads("quad vs kernel", res["quad"], res["kernel"],
                    ("out", "d_value", "d_loc", "d_attn"), dtype,
                    tol=qtol[dtype])
        del res
        if dtype == torch.bfloat16:
            for impl in ("quad", "kernel"):
                def fwd():
                    with torch.no_grad():
                        ms_deform_attn(v, shapes, loc, w, impl=impl)

                def fwd_bwd():
                    o = ms_deform_attn(v, shapes, loc, w, impl=impl)
                    torch.autograd.grad(o, leaves, d_out)

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fwd_bwd()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                times[f"MSDA {impl}"] = (cuda_ms(fwd, 20),
                                         cuda_ms(fwd_bwd, 20), peak)
    log_times({k: r for k, r in times.items() if k[:2] in ("K4", "K5")})
    for impl in ("quad", "kernel"):
        fwd, fwd_bwd, peak = times[f"MSDA {impl}"]
        log(f"  time bf16 MSDA impl={impl:<6} forward {fwd:.4f} ms, forward "
            f"+ backward {fwd_bwd:.4f} ms; peak {peak:.1f} MiB above the "
            "inputs")
    return err, times, launches


def k6_phase():
    """K6 through the probe tool: its parity check, K6 against its plain
    version at the tool's det-encoder level shapes, then the tool's
    per-level timing (the main path's run)."""
    from rscotr_tpu_torch.tools import probe_msda_weighted_gather_mm as probe
    dev = torch.device("cuda")
    log("K6 phase: probe_msda_weighted_gather_mm parity check")
    probe.parity(dev)
    log("K6 phase: weighted_gather_mm vs weighted_gather_mm_torch at G=8, "
        "K=53376, C=128, indices in [-2, Nv + 2)")
    g = torch.Generator(device="cuda").manual_seed(3)
    err = [0.0, 0.0]                               # [f32, bf16]
    for h, wd in probe.LEVELS:
        nv = h * wd
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(8, nv, 128, device="cuda",
                                generator=g).to(dtype)
            idx = torch.randint(-2, nv + 2, (8, 53376), device="cuda",
                                generator=g, dtype=torch.int32)
            w = torch.rand(8, 53376, device="cuda", generator=g)
            got = probe.weighted_gather_mm(table, idx, w, acc_dtype=dtype)
            torch.cuda.synchronize()
            ref = probe.weighted_gather_mm_torch(table, idx, w,
                                                 acc_dtype=dtype)
            d = (got - ref).abs()
            e = d.max().item()
            log(f"  K6 nv={nv:<6} {str(dtype)[6:]:<8} max_abs_err {e:.3e} "
                f"(tol {probe.PLAIN_RTOL:g}*|ref|: the same one product)")
            if (d - probe.PLAIN_RTOL * ref.abs()).max().item() > 0:
                fail(f"K6 nv={nv}: kernel disagrees with its plain version")
            err[dtype == torch.bfloat16] = max(err[dtype == torch.bfloat16],
                                               e)
    # -- the main path's run: the tool's per-level timing -----------------
    log("K6 phase: the probe's per-level timing (K6 vs production_level_"
        "slice, bf16, 20 x 8 chained calls per level)")
    iters, chain = 20, 8
    probe.weighted_gather_mm.launches = 0
    levels = probe.time_levels(dev, iters=iters, chain=chain)
    launches = probe.weighted_gather_mm.launches
    want = len(probe.LEVELS) * (iters + 1) * chain
    log(f"  launches in the main path's run: K6 {launches} (want {want})")
    if launches != want:
        fail(f"K6: {launches} launches in the probe's timing, want {want}")
    return err, levels, launches


def tiny_inputs():
    rng = np.random.default_rng(0)
    cls_img = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    det_img = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    hw = np.array([[128, 128], [100, 120]], np.int32)
    return cls_img, det_img, hw


def tiny_seg_inputs():
    """A 2 x 64^2 batch (whole mode) and a 1 x 64 x 96 one (slide mode: two
    64^2 windows at stride 32). Seed 3 keeps every attention-mask logit of
    the seed-0 tiny model at least 1.7e-3 from the threshold."""
    rng = np.random.default_rng(3)
    return (rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            rng.integers(0, 256, (1, 64, 96, 3)).astype(np.uint8))


SEG_SLIDE = dict(mode="slide", crop_size=(64, 64), stride=(32, 32))


def seg_mask_margin(model, imgs, seg_test_cfg):
    """The smallest |resized mask logit| entering any attention-mask
    threshold of the seg head over ``infer["seg"]`` of each image batch (a
    logit within float error of 0 would flip a mask bit between devices)."""
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models.heads import mask2former_head as m2f
    seen = []
    resize = m2f._interpolate

    def spy(x, hw):
        out = resize(x, hw)
        seen.append(out.abs().min().item())
        return out

    m2f._interpolate = spy
    try:
        steps = make_infer_steps(model, seg_test_cfg=seg_test_cfg)
        for img in imgs:
            steps["seg"](img)
    finally:
        m2f._interpolate = resize
    return min(seen)


def slice_parity_phase():
    from rscotr_tpu_torch.engine import device_normalize, make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("slice parity phase: tiny config (cls, det, seg), CPU (plain) vs "
        "CUDA (kernels), float32, TF32 off")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_model_cfg(TINY_CFG)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    cls_img, det_img, hw = tiny_inputs()
    seg_whole, seg_slide = tiny_seg_inputs()
    slide = (seg_slide[:, :, :64], seg_slide[:, :, 32:])
    margin = min(seg_mask_margin(cpu, (seg_whole,), cfg["test_cfg"]["seg"]),
                 seg_mask_margin(cpu, slide, None))
    log(f"  seg: smallest |resized mask logit| at an attention-mask "
        f"threshold {margin:.3e} (must exceed 10 x {SLICE_TOL:g})")
    if not margin > 10 * SLICE_TOL:
        fail("slice parity: a seg attention-mask logit lies within 10x the "
             "tolerance of the threshold; pick other inputs")
    sf = np.ones((2, 4), np.float32)
    results = {}
    for key, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        steps = make_infer_steps(model, max_per_img=50,
                                 seg_test_cfg=cfg["test_cfg"]["seg"])
        slide_steps = make_infer_steps(model, seg_test_cfg=SEG_SLIDE)
        with torch.inference_mode():
            img_hw = torch.as_tensor(hw, device=dev)
            img = device_normalize(torch.as_tensor(det_img, device=dev),
                                   None, img_hw)
            all_cls, all_coords, _, _ = model.forward_det(img, img_hw)
        det, labels = steps["det"](det_img, hw, sf)
        results[key] = dict(
            cls=steps["cls"](cls_img), all_cls=all_cls,
            all_coords=all_coords, det=det, labels=labels,
            seg_whole=steps["seg_logits"](seg_whole),
            seg_slide=slide_steps["seg_logits"](seg_slide),
            seg_labels=(steps["seg"](seg_whole),
                        slide_steps["seg"](seg_slide)))
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for key in ("cls", "all_cls", "all_coords", "det", "seg_whole",
                "seg_slide"):
        a, b = results["cpu"][key], results["cuda"][key].cpu()
        e = (a - b).abs().max().item()
        tol = SLICE_TOL * (max(hw.max(), 1) if key == "det" else 1)
        log(f"  {key:<11} shape {tuple(a.shape)} max_abs_err {e:.3e} "
            f"(tol {tol:g})")
        if not e <= tol:
            fail(f"slice parity: {key} differs between CPU and CUDA")
    if not torch.equal(results["cpu"]["labels"],
                       results["cuda"]["labels"].cpu()):
        fail("slice parity: det labels differ between CPU and CUDA")
    # seg labels: equal wherever the top two logits are more than 10x the
    # tolerance apart (elsewhere either label is right)
    for mode, logits, a, b in (
            ("whole", results["cpu"]["seg_whole"],
             *[r["seg_labels"][0].cpu() for r in results.values()]),
            ("slide", results["cpu"]["seg_slide"],
             *[r["seg_labels"][1].cpu() for r in results.values()])):
        top2 = logits.topk(2, -1).values
        clear = top2[..., 0] - top2[..., 1] > 10 * SLICE_TOL
        log(f"  seg labels ({mode}) {tuple(a.shape)}: equal on the "
            f"{clear.float().mean().item():.4f} of pixels whose top two "
            "logits are more than 10x the tolerance apart")
        if clear.float().mean() < 0.99 or not torch.equal(a[clear],
                                                          b[clear]):
            fail(f"slice parity: seg labels ({mode}) differ between CPU and "
                 "CUDA")


def check_grads(name, gots, refs, names, dtype, tol=None,
                slacks=None) -> float:
    """Hold each gradient against its plain version; one log line per case
    with each gradient's max abs error / max|ref|. Returns the largest
    max abs error. ``tol`` (atol scale, rtol) defaults to ``BTOL``;
    ``slacks``: per gradient, a tensor of further allowance or None."""
    atol, rtol = tol or BTOL[dtype]
    parts, worst = [], 0.0
    for i, (gname, got, ref) in enumerate(zip(names, gots, refs)):
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            fail(f"{name} {gname}: non-finite kernel gradient")
        err = (got - ref).abs()
        scale = ref.abs().max().item()
        max_err = err.max().item()
        slack = 0 if slacks is None or slacks[i] is None else slacks[i]
        over = err - rtol * ref.abs()
        if (over - slack).max().item() > atol * scale:
            fail(f"{name} {gname}: kernel gradient disagrees with the plain "
                 f"version (max_abs_err {max_err:.3e})")
        share = "" if slacks is None or slacks[i] is None else \
            f" ({(over > atol * scale).float().mean().item():.1e} need " \
            "P_FLIPS)"
        parts.append(f"{gname} {max_err:.2e}/{scale:.3g}{share}")
        worst = max(worst, max_err)
    log(f"  {name:<34} {str(dtype)[6:]:<8} max_abs_err/max|ref|: "
        f"{', '.join(parts)}  (tol {atol:g}*max|ref| + {rtol:g}*|ref|)")
    return worst


def ordered_k1b_parts(v, shapes, loc, w, d_out, acc):
    """K1b's ordered body at these tensors, part by part (CUDA-graph
    replay): the body with its value-gradient reduction off, the corner
    keys, the stable sort, the row bounds, the walk; the walk also over
    the coarsest level's rows alone (the hot rows, many corners each) and
    over the other rows alone. A log line and the dict."""
    from rscotr_tpu_torch.ops import kernel_lib
    from rscotr_tpu_torch.ops.kernel_lib import BODY_VEC, ORDERED
    from rscotr_tpu_torch.ops.ms_deform_attn import _levels_arg
    lib = kernel_lib.load()
    B, Nv, H, D = v.shape
    _, Q, _, L, P, _ = loc.shape
    dt, wt = (kernel_lib.dtype_code(t, "") for t in (v, w))
    lv = _levels_arg(shapes)

    def st():
        # the stream current at the call: graph_ms captures on its own
        return kernel_lib.stream_ptr(v.device)

    d_attn, d_loc = torch.empty_like(w), torch.empty_like(loc)
    keys = torch.empty(B * Q * H * L * P * 4, dtype=torch.int32,
                       device=v.device)
    lib.msda_bwd_keys(loc.data_ptr(), B, Nv, Q, H, L, P, lv, keys.data_ptr(),
                      st())
    sk, perm = torch.sort(keys, stable=True)
    start = torch.zeros(B * Nv * H, dtype=torch.int64, device=v.device)
    end = torch.zeros_like(start)
    lib.msda_bwd_bounds(sk.data_ptr(), sk.numel(), start.data_ptr(),
                        end.data_ptr(), st())

    def walk(s, e):
        lib.msda_bwd_walk(dt, loc.data_ptr(), w.data_ptr(), wt,
                          d_out.data_ptr(), perm.data_ptr(), s.data_ptr(),
                          e.data_ptr(), acc.data_ptr(), B, Nv, Q, H, D, L, P,
                          lv, BODY_VEC, st())

    hot = (B * Nv - B * shapes[-1][0] * shapes[-1][1]) * H  # B == 1
    hot_s, hot_e, cold_s, cold_e = (t.clone() for t in (start, end) * 2)
    for t in (hot_s, hot_e):
        t[:hot] = 0
    for t in (cold_s, cold_e):
        t[hot:] = 0
    parts = dict(
        body_ms=graph_ms(lambda: lib.msda_bwd(
            v.data_ptr(), dt, loc.data_ptr(), w.data_ptr(), wt,
            d_out.data_ptr(), d_attn.data_ptr(), d_loc.data_ptr(),
            acc.data_ptr(), B, Nv, Q, H, D, L, P, lv, BODY_VEC | ORDERED,
            st())),
        keys_ms=graph_ms(lambda: lib.msda_bwd_keys(
            loc.data_ptr(), B, Nv, Q, H, L, P, lv, keys.data_ptr(), st())),
        sort_ms=graph_ms(lambda: torch.sort(keys, stable=True)),
        bounds_ms=graph_ms(lambda: lib.msda_bwd_bounds(
            sk.data_ptr(), sk.numel(), start.data_ptr(), end.data_ptr(),
            st())),
        walk_ms=graph_ms(lambda: walk(start, end)),
        walk_coarsest_rows_ms=graph_ms(lambda: walk(hot_s, hot_e)),
        walk_other_rows_ms=graph_ms(lambda: walk(cold_s, cold_e)),
        corners=int((end - start).sum()),
        coarsest_corners=int((hot_e - hot_s).sum()),
        most_corners_a_row=int((end - start).max()))
    log(f"    K1b ordered body, parts: the body without its reduction "
        f"{parts['body_ms']:.4f} ms, keys {parts['keys_ms']:.4f}, stable "
        f"sort {parts['sort_ms']:.4f}, bounds {parts['bounds_ms']:.4f}, walk "
        f"{parts['walk_ms']:.4f} ({parts['corners']} corners; the "
        f"{shapes[-1][0]}x{shapes[-1][1]} level's rows alone "
        f"{parts['walk_coarsest_rows_ms']:.4f} ms for "
        f"{parts['coarsest_corners']} corners, up to "
        f"{parts['most_corners_a_row']} a row; the other rows "
        f"{parts['walk_other_rows_ms']:.4f} ms)")
    return parts


def ordered(fn):
    """``fn`` called under ``--deterministic``'s switches (torch's fill of
    new tensors off, as it adds nothing to a kernel's own work): K1b and
    K2b take their ordered bodies there."""
    def call(*args, **kw):
        with deterministic_algorithms(True, fill=False):
            return fn(*args, **kw)
    return call


def check_ordered(name, call, as_grads, refs, names, dtype, slacks=None):
    """A kernel's ordered body (``call`` under ``ordered``, the body
    ``torch.use_deterministic_algorithms`` picks): two calls on the same
    tensors give the same bits, and the result is held against the plain
    version by ``check_grads``. ``as_grads`` maps the call's result to the
    gradients ``refs`` name. Returns the largest max abs error."""
    first, second = call(), call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{name} (ordered body): two calls on the same tensors differ")
    return check_grads(f"{name} (ordered, 2 calls bit-equal)",
                       as_grads(first), refs, names, dtype, slacks=slacks)


def backward_phase():
    from rscotr_tpu_torch.ops import flops
    from rscotr_tpu_torch.ops.ms_deform_attn import (
        BODY_LANE, BODY_VEC, _msda_bwd_cuda, ms_deform_attn,
        ms_deform_attn_bwd, ms_deform_attn_bwd_torch, msda_bwd_body,
        msda_bwd_rows_torch)
    from rscotr_tpu_torch.ops.scatter_mm import (_scatter_add_cuda,
                                                 scatter_add_mm,
                                                 scatter_add_mm_torch)
    from rscotr_tpu_torch.ops.window_attention import (
        _window_attention_bwd_cuda, window_attention, window_attention_bwd,
        window_attention_bwd_torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    err = {k: [0.0, 0.0] for k in ("K1b", "K3", "K2b")}   # [f32, bf16]
    times = {}
    Nv = sum(h * w for h, w in DET_SHAPES)
    seg_nv = sum(h * w for h, w in SEG_SHAPES)
    log("backward phase: K1b msda_bwd (autograd through ms_deform_attn: one "
        "launch, the value-gradient scatter fused in) vs "
        "ms_deform_attn_bwd_torch")
    # name: msda_inputs arguments, the body the launch must take, timed.
    # The timed det-encoder case runs twice: with the locations of every
    # other kernel case, [-0.2, 1.2], which leave about half the corners
    # off the map (skipped), and with [0, 1], where nearly every corner is
    # loaded and reduced, as a model's locations mostly are.
    cases = {
        "det-encoder B=1": (dict(B=1, Q=Nv), BODY_VEC, True),
        "det-encoder B=1 loc in [0, 1]": (dict(B=1, Q=Nv, span=(0.0, 1.0)),
                                          BODY_VEC, True),
        "train decoder B=1 Q=800": (dict(B=1, Q=800), BODY_VEC, True),
        "seg-encoder B=4": (dict(B=4, Q=seg_nv, shapes=SEG_SHAPES),
                            BODY_VEC, False),
        "head width 64 Q=4000 H=4": (dict(B=1, Q=4000, H=4, D=64), BODY_VEC,
                                     False),
        "head width 24 Q=4000 (lane body)": (dict(B=1, Q=4000, D=24),
                                             BODY_LANE, False),
        "edge locations [-0.1, 1.1]": (dict(B=1, Q=4000, span=(-0.1, 1.1)),
                                       BODY_VEC, False),
        "paper cls-encoder B=16": (dict(
            B=16, Q=sum(h * w for h, w in CLS_SHAPES), shapes=CLS_SHAPES),
            BODY_VEC, False),
        "RSCoTrSeg-R50 encoder B=2 L=3": (dict(
            B=2, Q=sum(h * w for h, w in RSEG_SHAPES), shapes=RSEG_SHAPES),
            BODY_VEC, False),
    }
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (kw, body, timed) in cases.items():
            v, shapes, loc, w = msda_inputs(dtype=dtype, g=g, **kw)
            if msda_bwd_body(v.shape[-1], [v.data_ptr()]) != body:
                fail(f"K1b {name}: not the body the case is meant for")
            v, loc, w = (t.requires_grad_() for t in (v, loc, w))
            out = ms_deform_attn(v, shapes, loc, w)
            d_out = torch.randn(out.shape, device="cuda",
                                generator=g).to(dtype)
            before = (ms_deform_attn_bwd.launches, scatter_add_mm.launches)
            got = torch.autograd.grad(out, (v, loc, w), d_out)
            torch.cuda.synchronize()
            if (ms_deform_attn_bwd.launches, scatter_add_mm.launches) != \
                    (before[0] + 1, before[1]):
                fail(f"K1b {name}: the backward is not one K1b launch")
            v, loc, w = v.detach(), loc.detach(), w.detach()
            ref = ms_deform_attn_bwd_torch(v, shapes, loc, w, d_out)
            e = check_grads(f"K1b {name}", got, ref,
                            ("d_value", "d_loc", "d_attn"), dtype)
            err["K1b"][bf] = max(err["K1b"][bf], e)
            # the ordered body (--deterministic's) on the same tensors: two
            # calls bit-equal, each within the same tolerance
            e = check_ordered(
                f"K1b {name}", lambda: ordered(_msda_bwd_cuda)(
                    v, shapes, loc, w, d_out),
                lambda r: (r[0].to(dtype), r[1], r[2]), ref,
                ("d_value", "d_loc", "d_attn"), dtype)
            err["K1b"][bf] = max(err["K1b"][bf], e)
            if not timed:
                continue
            if bf:
                args = (v, shapes, loc, w, d_out)
                D = v.shape[-1]
                on_map = corners_on_map(shapes, loc)
                # per corner on the map: D multiply-adds for <V_c, d_out>,
                # D products and D atomic adds for d_value
                ms, by = bound((v, loc, w, d_out) + got,
                               flops.msda_bwd_flops(on_map, D),
                               "f32")
                # a model of the L2 traffic, not a reading: each corner
                # row loaded, each accumulator row read and written by its
                # reduction
                l2 = on_map * D * (v.element_size() + 8)
                log(f"  K1b {name}: {on_map} corners on the map; corner "
                    f"rows loaded {on_map * D * v.element_size() / 1e6:.1f} "
                    f"MB, accumulator rows reduced into "
                    f"{on_map * D * 8 / 1e6:.1f} MB (read + write), "
                    f"{1e3 * l2 / HBM_BYTES_PER_S:.4f} ms at the device-"
                    "memory rate (modelled from the corner count)")
                acc = torch.zeros(v.shape, device="cuda")

                def kernel():
                    _msda_bwd_cuda(*args, acc=acc)

                times[f"K1b {name}"] = dict(
                    ms=graph_ms(kernel), eager_ms=cuda_ms(kernel, 50),
                    ordered_ms=graph_ms(lambda: ordered(_msda_bwd_cuda)(
                        *args, acc=acc)),
                    ordered_parts=ordered_k1b_parts(*args, acc),
                    whole_ms=graph_ms(lambda: ms_deform_attn_bwd(*args)),
                    whole_eager_ms=cuda_ms(
                        lambda: ms_deform_attn_bwd(*args), 50),
                    plain_ms=cuda_ms(
                        lambda: ms_deform_attn_bwd_torch(*args), 5),
                    bound_ms=ms, bound_by=by, library_ms=None)
                del acc
            if name.startswith("edge") or kw.get("shapes") in (CLS_SHAPES,
                                                               RSEG_SHAPES):
                continue
            # K3' alone, on the plain backward's quad-row updates (C = 4 D):
            # the vector body, and the scalar body forced on the same tensors
            d_g, gidx = msda_bwd_rows_torch(v, shapes, loc, w, d_out)[:2]
            d_g, gidx = d_g.contiguous(), gidx.contiguous()
            rows = v.shape[1]
            vec = scatter_add_mm.vec_launches
            d_qt = scatter_add_mm(d_g, gidx, rows)
            scalar = _scatter_add_cuda(d_g, gidx, torch.zeros_like(d_qt),
                                       body=BODY_LANE)
            torch.cuda.synchronize()
            if scatter_add_mm.vec_launches != vec + 1:
                fail(f"K3' {name}: not one launch on the vector body")
            want = scatter_add_mm_torch(d_g, gidx, rows)
            e = check_grads(f"K3' {name}", [d_qt], [want], ("d_qt",),
                            torch.float32)
            check_grads(f"K3' {name} (scalar body)", [scalar], [want],
                        ("d_qt",), torch.float32)
            err["K3"][bf] = max(err["K3"][bf], e)
            del scalar, want
            # timed at the det encoder, both location spans: the kernel
            # alone into a zeroed accumulator as ``ms``, the whole wrapper
            # (zero fill and kernel) as ``whole_ms``
            if bf and kw["Q"] == Nv and kw["B"] == 1:
                acc = torch.zeros_like(d_qt)

                def kernel():
                    _scatter_add_cuda(d_g, gidx, acc)

                # one f32 add per update element
                ms, by = bound((d_g, gidx, d_qt), float(d_g.numel()), "f32")
                times[f"K3' {name}"] = dict(
                    ms=graph_ms(kernel), eager_ms=cuda_ms(kernel, 20),
                    scalar_ms=graph_ms(lambda: _scatter_add_cuda(
                        d_g, gidx, acc, body=BODY_LANE)),
                    whole_ms=graph_ms(lambda: scatter_add_mm(d_g, gidx,
                                                             rows)),
                    whole_eager_ms=cuda_ms(
                        lambda: scatter_add_mm(d_g, gidx, rows), 20),
                    plain_ms=cuda_ms(
                        lambda: scatter_add_mm_torch(d_g, gidx, rows), 5),
                    bound_ms=ms, bound_by=by,
                    library_ms=index_add_yardstick(d_g, gidx, rows, d_qt))
                del acc
            del d_g, gidx, d_qt
    log("backward phase: K2b window_attn_bwd (autograd through "
        "window_attention) vs window_attention_bwd_torch")
    for dtype in (torch.float32, torch.bfloat16):
        bf = int(dtype == torch.bfloat16)
        for name, (B, nW, H, shifted), kw in k2_cases():
            for masked in sorted({False, shifted}):
                timed = bool(bf and masked == shifted and name in TIMED_K2)
                if timed:
                    q, k, v, bias, mask, scale, d_out = timed_wa_inputs(name)
                else:
                    q, k, v, bias, mask, scale = wa_inputs(
                        B, nW, H, masked, dtype, g, **kw)
                    d_out = torch.randn(q.shape, device="cuda",
                                        generator=g).to(dtype)
                q, k, v, bias = (t.requires_grad_() for t in (q, k, v, bias))
                out = window_attention(q, k, v, bias, mask, scale)
                before = window_attention_bwd.launches
                got = torch.autograd.grad(out, (q, k, v, bias), d_out)
                torch.cuda.synchronize()
                if window_attention_bwd.launches != before + 1:
                    fail(f"K2b {name}: the wrapper counted no launch")
                q, k, v, bias = (t.detach() for t in (q, k, v, bias))
                ref = window_attention_bwd_torch(q, k, v, bias, mask, scale,
                                                 d_out)
                e = check_grads(
                    f"K2b {name}{' masked' if masked else ''}", got, ref,
                    ("dq", "dk", "dv", "d_rel_bias"), dtype,
                    slacks=k2_ulp_slack(q, k, v, bias, mask, scale, d_out)
                    if bf else None)
                err["K2b"][bf] = max(err["K2b"][bf], e)
                e = check_ordered(
                    f"K2b {name}{' masked' if masked else ''}",
                    lambda: ordered(_window_attention_bwd_cuda)(
                        q, k, v, bias, mask, scale, d_out),
                    lambda r: r, ref, ("dq", "dk", "dv", "d_rel_bias"),
                    dtype, slacks=k2_ulp_slack(q, k, v, bias, mask, scale,
                                               d_out) if bf else None)
                err["K2b"][bf] = max(err["K2b"][bf], e)
                if timed:
                    args = (q, k, v, bias, mask, scale, d_out)
                    n, hd = q.shape[-2:]
                    # five n x n x hd products per tile: S, dP, dV, dQ, dK
                    ms, by = bound((q, k, v, bias, mask, d_out) + got,
                                   flops.window_attn_bwd_flops(
                                       B * nW * H, n, hd),
                                   "bf16 tensor")
                    times[f"K2b {name}"] = dict(
                        ms=graph_ms(lambda: window_attention_bwd(*args)),
                        ordered_ms=graph_ms(
                            lambda: ordered(_window_attention_bwd_cuda)(
                                *args)),
                        eager_ms=cuda_ms(
                            lambda: window_attention_bwd(*args), 20),
                        plain_ms=cuda_ms(
                            lambda: window_attention_bwd_torch(*args), 5),
                        bound_ms=ms, bound_by=by, library_ms=None)
    log_times(times)
    return err, times


# K2 / K2b with attention dropout (Swin's attn_drop_rate in training): the
# rate and seed of every dropout case, and the stage they run at
DROP_P, DROP_SEED = 0.1, 20261018
DROP_STAGE = "det800.s0"


def keep_pattern(B, nW, H, dtype, p, seed, n=49):
    """The keep bits K2 and K2b applied at (B, nW, H, n, n), read back: K2
    with q, k random and v the identity (head width 64 >= n, so output row
    i is P'_i, zero exactly where dropped; no bias or mask, so every P is
    above 0), K2b's dV = P'^T dO with a one-hot dO. f32 takes the CUDA-core
    bodies, bf16 the tensor-core ones."""
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k = (torch.randn(B, nW, H, n, 64, device="cuda", generator=g
                        ).to(dtype) for _ in range(2))
    eye = torch.eye(n, 64, device="cuda", dtype=dtype).expand(
        B, nW, H, n, 64).contiguous()
    bias = torch.zeros(H, n, n, device="cuda")
    fwd = window_attention(q, k, eye, bias, None, 0.125, p, seed)
    dv = window_attention_bwd(q, k, eye, bias, None, 0.125, eye, p, seed)[2]
    torch.cuda.synchronize()
    return fwd[..., :n] != 0, dv[..., :n].transpose(-1, -2) != 0


def dropout_phase(times, btimes):
    """K2 / K2b's DROP bodies at det 800^2 stage 0 with p = 0.1, f32 and
    bf16, without and with the shift mask: the keep bits bit for bit
    against ``ops.philox.keep_mask`` (which the plain versions use), the
    keep fraction within 5 binomial sigma of 0.9, the values within K2's
    and K2b's tolerances of the plain versions on the same bits, the same
    seed bit-equal and another seed not, K2b's ordered body twice
    bit-equal; then the DROP bodies' device time beside the p = 0 bodies'
    on the timed stage's own tensors (``dropout_ms``, in turns)."""
    from rscotr_tpu_torch.ops import philox
    from rscotr_tpu_torch.ops.window_attention import (
        _window_attention_bwd_cuda, window_attention, window_attention_bwd,
        window_attention_bwd_torch, window_attention_torch)
    log(f"dropout phase: K2 / K2b with attention dropout p = {DROP_P} (the "
        "DROP bodies) vs the plain versions on the same Philox bits, "
        f"{DROP_STAGE}")
    B, nW, H, _ = K2_SHAPES[DROP_STAGE]
    want = philox.keep_mask((B, nW, H, 49, 49), DROP_P, DROP_SEED, "cuda")
    N = want.numel()
    frac = want.float().mean().item()
    sigma = (DROP_P * (1 - DROP_P) / N) ** 0.5
    log(f"  keep fraction {frac:.6f} of {N} entries (expected "
        f"{1 - DROP_P}, {abs(frac - 1 + DROP_P) / sigma:.2f} sigma)")
    if abs(frac - (1 - DROP_P)) > 5 * sigma:
        fail("dropout: keep fraction beyond 5 sigma")
    g = torch.Generator(device="cuda").manual_seed(11)
    names = ("dq", "dk", "dv", "d_rel_bias")
    drop = (DROP_P, DROP_SEED)
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        fwd_bits, bwd_bits = keep_pattern(B, nW, H, dtype, *drop)
        for what, bits in (("K2", fwd_bits), ("K2b", bwd_bits)):
            if not torch.equal(bits, want):
                fail(f"{what} dropout {str(dtype)[6:]}: "
                     f"{(bits != want).sum().item()} keep bits differ from "
                     "the plain version's")
        log(f"  keep bits {str(dtype)[6:]}: K2 and K2b equal the plain "
            f"version's on all {N} entries")
        for masked in (False, True):
            tag = f"{DROP_STAGE} dropout{' masked' if masked else ''}"
            q, k, v, bias, mask, scale = wa_inputs(B, nW, H, masked, dtype,
                                                   g)
            got = window_attention(q, k, v, bias, mask, scale, *drop)
            ref = window_attention_torch(q, k, v, bias, mask, scale, *drop)
            check_close(f"K2 {tag}", got, ref.float(), dtype,
                        k2_ulp_slack(q, k, v, bias, mask, scale, drop=drop)
                        if bf else None)
            if not torch.equal(got, window_attention(
                    q, k, v, bias, mask, scale, *drop)):
                fail(f"K2 {tag}: the same seed gave other bits")
            if torch.equal(got, window_attention(
                    q, k, v, bias, mask, scale, DROP_P, DROP_SEED + 1)):
                fail(f"K2 {tag}: another seed gave the same output")
            d_out = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
            out = window_attention(*leaves[:3], leaves[3], mask, scale, *drop)
            grads = torch.autograd.grad(out, leaves, d_out)
            refs = window_attention_bwd_torch(q, k, v, bias, mask, scale,
                                              d_out, *drop)
            slacks = k2_ulp_slack(q, k, v, bias, mask, scale, d_out,
                                  drop) if bf else None
            check_grads(f"K2b {tag}", grads, refs, names, dtype,
                        slacks=slacks)
            check_ordered(f"K2b {tag}", lambda: ordered(
                _window_attention_bwd_cuda)(q, k, v, bias, mask, scale,
                                            d_out, *drop),
                lambda r: r, refs, names, dtype, slacks=slacks)
    # the DROP bodies beside the p = 0 ones on the timed stage's tensors
    q, k, v, bias, mask, scale, d_out = timed_wa_inputs(DROP_STAGE)
    runs = {"fwd": (lambda: window_attention(q, k, v, bias, mask, scale),
                    lambda: window_attention(q, k, v, bias, mask, scale,
                                             *drop)),
            "bwd": (lambda: window_attention_bwd(q, k, v, bias, mask, scale,
                                                 d_out),
                    lambda: window_attention_bwd(q, k, v, bias, mask, scale,
                                                 d_out, *drop))}
    for kind, (plain0, dropped) in runs.items():
        t0, t1 = [], []
        for _ in range(2):   # in turns: p = 0, dropout, dropout, p = 0
            t0.append(graph_ms(plain0))
            t1.append(graph_ms(dropped))
            t1.append(graph_ms(dropped))
            t0.append(graph_ms(plain0))
        rec = (times if kind == "fwd" else btimes)[
            f"{'K2' if kind == 'fwd' else 'K2b'} {DROP_STAGE}"]
        rec.update(dropout_ms=float(np.median(t1)),
                   dropout_p0_ms=float(np.median(t0)), dropout_p=DROP_P)
        log(f"  time bf16 {'K2' if kind == 'fwd' else 'K2b'} {DROP_STAGE} "
            f"p = {DROP_P}: {np.median(t1):.4f} ms against p = 0 "
            f"{np.median(t0):.4f} ms on the same tensors (graph replay, "
            f"median of 4 each, in turns)")


def tiny_train_batches(cdn):
    rng = np.random.default_rng(5)
    cls = dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
               gt_label=rng.integers(0, 45, 2).astype(np.int32))
    G = cdn.max_gt
    hw = np.array([[128, 128], [100, 120]], np.int32)
    boxes = np.zeros((2, G, 4), np.float32)
    labels = np.zeros((2, G), np.int32)
    valid = np.zeros((2, G), bool)
    for b, n in enumerate((3, 6)):
        xy = rng.uniform(0, 70, (n, 2))
        wh = rng.uniform(8, 40, (n, 2))
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh,
                                                      hw[b, ::-1])], 1)
        labels[b, :n] = rng.integers(0, 20, n)
        valid[b, :n] = True
    det = dict(img=rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8),
               img_hw=hw, gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)
    shape = (2, 2 * cdn.num_groups, cdn.single_pad)
    noises = [dict(
        dn_noise_p=rng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))
        for _ in range(2)]
    return cls, det, noises


def train_parity_phase():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn_bwd
    from rscotr_tpu_torch.ops.window_attention import window_attention_bwd
    from rscotr_tpu_torch.utils.config import load_cfg
    log("training parity phase: tiny config trains cls, det, det, cls on "
        "the CPU (plain) and on CUDA (kernels), float32, TF32 off, mixup "
        "on (same CPU generator seed), CDN noise injected")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_cfg(TINY_CFG)
    step_cfg = make_step_config(cfg)
    cls_b, det_b, noises = tiny_train_batches(step_cfg.cdn)
    logs, models = {}, {}
    init = None
    for dev in ("cpu", "cuda"):
        model = build_model(cfg["model"], tasks=("cls", "det"), device=dev,
                            generator=torch.Generator().manual_seed(0))
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init, strict=True)
        opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                              lr_config=cfg["lr_config"],
                              grad_clip=cfg["optimizer_config"]["grad_clip"])
        masks = task_param_masks(n for n, _ in model.named_parameters())
        steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
                 for t in ("cls", "det")}
        gen = torch.Generator().manual_seed(0)
        logs[dev] = []
        k1b = ms_deform_attn_bwd.launches
        k2b = window_attention_bwd.launches
        for i, task in enumerate(("cls", "det", "det", "cls")):
            batch = cls_b if task == "cls" else dict(det_b, **noises[i - 1])
            lv = steps[task](batch, gen)
            logs[dev].append((task, {k: float(v) for k, v in lv.items()}))
        if dev == "cuda" and (ms_deform_attn_bwd.launches == k1b or
                              window_attention_bwd.launches == k2b):
            fail("training parity: the CUDA run launched no backward "
                 "kernel")
        models[dev] = model
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    for i, ((task, want), (_, got)) in enumerate(zip(logs["cpu"],
                                                     logs["cuda"])):
        worst = max((abs(got[k] - want[k]) - TRAIN_RTOL * abs(want[k]), k)
                    for k in want)
        log(f"  step {i} {task}: {len(want)} terms, loss {want['loss']:.6f}"
            f" vs {got['loss']:.6f}, grad_norm {want['grad_norm']:.5f} vs "
            f"{got['grad_norm']:.5f}; worst excess {worst[0]:.2e} "
            f"({worst[1]}, tol {TRAIN_ATOL:g})")
        if set(got) != set(want) or worst[0] > TRAIN_ATOL:
            fail(f"training parity: step {i} ({task}) differs")
    sd_cpu = models["cpu"].state_dict()
    n_out, n_all, worst = 0, 0, (0.0, "")
    for n, p in models["cuda"].state_dict().items():
        ref = sd_cpu[n]
        d = (p.cpu() - ref).abs()
        n_out += int((d > PARAM_ATOL + PARAM_RTOL * ref.abs()).sum())
        n_all += d.numel()
        worst = max(worst, (d.max().item(), n))
    log(f"  final params: {n_out} of {n_all} elements outside {PARAM_ATOL:g}"
        f" + {PARAM_RTOL:g}*|w| (allowed {PARAM_FRAC:g} of them); max abs "
        f"diff {worst[0]:.2e} ({worst[1]}, allowed {PARAM_MAX:g})")
    if n_out > PARAM_FRAC * n_all or worst[0] > PARAM_MAX:
        fail("training parity: final parameters differ")


def serving_phase():
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.layers.common import LayerNorm
    from rscotr_tpu_torch.ops.layer_norm import layer_norm
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.msda_ws import ws_fwd
    from rscotr_tpu_torch.ops.window_attention import window_attention
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("serving phase: flagship MTL (cls + det + seg), bf16, random "
        "weights (seed 0)")
    cfg = load_model_cfg(FLAGSHIP_CFG)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built {n_params} params on cuda in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = make_infer_steps(model, max_per_img=300,
                             seg_test_cfg=cfg["test_cfg"]["seg"])
    if cfg["test_cfg"]["seg"].get("mode", "whole") != "whole":
        fail("flagship seg test_cfg: expected whole mode")
    rng = np.random.default_rng(0)
    reqs = {
        "cls 16x224^2": ("cls", (rng.integers(
            0, 256, (16, 224, 224, 3)).astype(np.uint8),)),
        "det 1x800^2": ("det", (
            rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8),
            np.array([[800, 800]], np.int32), np.ones((1, 4), np.float32))),
        "det 4x800^2": ("det", (
            rng.integers(0, 256, (4, 800, 800, 3)).astype(np.uint8),
            np.array([[800, 800], [800, 704], [640, 800], [512, 600]],
                     np.int32), np.ones((4, 4), np.float32))),
        "seg 4x512^2": ("seg", (rng.integers(
            0, 256, (4, 512, 512, 3)).astype(np.uint8),)),
        "seg 1x512^2": ("seg", (rng.integers(
            0, 256, (1, 512, 512, 3)).astype(np.uint8),)),
    }
    # -- the main path's run: one request of each kind, counted -----------
    # K1: 6 encoder + 6 decoder layers per det forward, 6 encoder layers per
    # seg forward (the pixel decoder); K2: 12 Swin blocks per backbone pass
    # (every K1 launch takes the vector body: head width 32)
    want = {"cls": (0, 12), "det": (12, 12), "seg": (6, 12)}
    ms_deform_attn.launches = 0
    ms_deform_attn.vec_launches = 0
    window_attention.launches = 0
    layer_norm.launches = 0
    k4 = ws_fwd.launches
    # K7: one launch per LayerNorm call (a hook counts the calls)
    ln_calls = [0]

    def count_call(*_):
        ln_calls[0] += 1

    hooks = [m.register_forward_hook(count_call) for m in model.modules()
             if isinstance(m, LayerNorm)]
    outs, k7_per_request = {}, {}
    for name, (task, args) in reqs.items():
        k1, k2 = ms_deform_attn.launches, window_attention.launches
        vec = ms_deform_attn.vec_launches
        k7, ln_calls[0] = layer_norm.launches, 0
        outs[name] = steps[task](*args)
        got = (ms_deform_attn.launches - k1, window_attention.launches - k2)
        vec = ms_deform_attn.vec_launches - vec
        k7_per_request[name] = layer_norm.launches - k7
        log(f"  launches in {name}: K1 {got[0]} ({vec} vector body), K2 "
            f"{got[1]} (want {want[task][0]}, all vector body, "
            f"{want[task][1]}), K7 {k7_per_request[name]} (want "
            f"{ln_calls[0]}, the LayerNorm calls)")
        if got != want[task] or vec != got[0]:
            fail(f"{name}: kernel launches {got} ({vec} K1 vector body) != "
                 f"{want[task]}")
        if k7_per_request[name] != ln_calls[0]:
            fail(f"{name}: K7 launches {k7_per_request[name]} != LayerNorm "
                 f"calls {ln_calls[0]}")
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    if ws_fwd.launches != k4:
        fail("serving launched K4: the quad-gather path is not the model's")
    launches = {"K1": ms_deform_attn.launches, "K2": window_attention.launches,
                "K1 vec": ms_deform_attn.vec_launches,
                "K7": layer_norm.launches, "K7 per request": k7_per_request}
    log(f"  launches in the main path's run: K1 {launches['K1']} "
        f"({launches['K1 vec']} vector body), K2 {launches['K2']}, K7 "
        f"{launches['K7']}")

    probs = outs["cls 16x224^2"].float()
    if tuple(probs.shape) != (16, 45) or not torch.isfinite(probs).all() or \
            (probs.sum(-1) - 1).abs().max() > 1e-3:
        fail(f"cls output invalid: shape {tuple(probs.shape)}")
    log(f"  cls: probs {tuple(probs.shape)}, finite, rows sum to 1 "
        f"(max dev {(probs.sum(-1) - 1).abs().max().item():.2e})")
    for name in ("det 1x800^2", "det 4x800^2"):
        det, labels = outs[name]
        hw = torch.as_tensor(reqs[name][1][1], device="cuda")
        B = hw.shape[0]
        box, score = det[..., :4], det[..., 4]
        lim = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                          -1)[:, None].float()
        ok = (tuple(det.shape) == (B, 300, 5)
              and tuple(labels.shape) == (B, 300)
              and bool(torch.isfinite(det).all())
              and bool(((box >= 0) & (box <= lim)).all())
              and bool(((score >= 0) & (score <= 1)).all())
              and bool(((labels >= 0) & (labels < 20)).all()))
        if not ok:
            fail(f"{name}: output invalid")
        log(f"  {name}: det {tuple(det.shape)}, labels {tuple(labels.shape)}"
            f", finite, boxes inside the image, labels in [0, 20), top "
            f"score {score.max().item():.4f}")
    # scheme 2: one logit channel per query (100), argmaxed over all of them
    C = cfg["seg_head"]["num_queries"]
    for name in ("seg 4x512^2", "seg 1x512^2"):
        labels = outs[name]
        B = reqs[name][1][0].shape[0]
        if tuple(labels.shape) != (B, 512, 512) or \
                labels.dtype != torch.int64 or \
                not bool(((labels >= 0) & (labels < C)).all()):
            fail(f"{name}: labels invalid: {tuple(labels.shape)} "
                 f"{labels.dtype}")
        log(f"  {name}: labels {tuple(labels.shape)} in [0, {C}), "
            f"{labels.unique().numel()} distinct")
    logits = steps["seg_logits"](*reqs["seg 1x512^2"][1])
    if tuple(logits.shape) != (1, 512, 512, C) or \
            logits.dtype != torch.float32 or not torch.isfinite(logits).all():
        fail(f"seg logits invalid: {tuple(logits.shape)} {logits.dtype}")
    log(f"  seg 1x512^2: logits {tuple(logits.shape)} float32, finite")
    del logits

    # -- latency and memory ----------------------------------------------
    lat = {}
    for name, (task, args) in reqs.items():
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(23):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps[task](*args)
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        lat[name] = (float(np.median(times)), peak)
        log(f"  latency {name:<12} median {lat[name][0]:.3f} ms over "
            f"{len(times)} requests (min {min(times):.3f}, max "
            f"{max(times):.3f}); peak memory {peak:.1f} MiB")
    return launches, lat


class _Eager(contextlib.AbstractContextManager):
    """A dispatch mode that only passes each op on: under it the DINO head
    runs its selection and decoder eagerly (a mode sees every op), on the
    same kernels."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Pass(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return func(*args, **(kwargs or {}))
        self.mode = Pass()
        return self.mode.__enter__()

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def det_graph_phase():
    """The DINO head's selection and decoder as one CUDA-graph replay per
    input key (``models/heads/dino_head.py``), at the flagship's det
    request: 16 tiles of 800^2, bf16, random weights of seed 0. Returns
    {"eager_ms", "replay_ms", "gaps", "syncs"}."""
    from torch.profiler import ProfilerActivity, profile

    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.heads.dino_head import DINOHead
    from rscotr_tpu_torch.models.layers.attention import scaled_logits
    from rscotr_tpu_torch.ops.layer_norm import layer_norm
    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.utils import trace
    from rscotr_tpu_torch.utils.config import load_model_cfg
    log("det graph phase: the flagship's DINO head replayed as a CUDA graph "
        "at det 16x800^2, bf16, random weights (seed 0)")

    # -- the attention scale: the host-copied divisor's quotient, bit for bit
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64):
            q = (3 * torch.randn(16, 8, 600, hd, device="cuda",
                                 generator=g)).to(dtype).requires_grad_()
            k = (3 * torch.randn(16, 8, 600, hd, device="cuda",
                                 generator=g)).to(dtype).requires_grad_()
            w = torch.randn(16, 8, 600, 600, device="cuda", generator=g)
            old = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(
                torch.tensor(float(hd), dtype=dtype, device="cuda"))
            new = scaled_logits(q, k)
            got = torch.autograd.grad((new * w).sum(), (q, k))
            want = torch.autograd.grad((old * w).sum(), (q, k))
            if not (torch.equal(new, old) and all(
                    torch.equal(a, b) for a, b in zip(got, want))):
                fail(f"scaled_logits {dtype} hd {hd}: not bit-equal to the "
                     "host-copied divisor's quotient")
    log("  scaled_logits: logits and gradients bit-equal to the "
        "host-copied divisor's, f32 and bf16, head widths 16 / 32 / 64")

    cfg = load_model_cfg(FLAGSHIP_CFG)
    model = build_model(cfg, tasks=("det",), device="cuda",
                        generator=torch.Generator().manual_seed(0))
    step = make_infer_steps(model, max_per_img=300)["det"]
    head = model.bbox_head
    rng = np.random.default_rng(0)
    B = 16
    hw = np.full((B, 2), 800, np.int32)
    imgs = [rng.integers(0, 256, (B, 800, 800, 3)).astype(np.uint8)
            for _ in range(3)]
    kept = {}

    def hook(_m, _i, out):
        kept["head"] = out

    model.bbox_head.register_forward_hook(hook)
    names = ("all_cls", "all_coords", "topk_score", "topk_anchor", "bboxes",
             "labels")

    def request(img, eager=False):
        with _Eager() if eager else contextlib.nullcontext():
            det = step(img, hw)
        return dict(zip(names, tuple(kept.pop("head")) + tuple(det)))

    def counts():
        return (DINOHead.graph_captures, DINOHead.graph_replays,
                DINOHead.eager_calls, ms_deform_attn.launches,
                layer_norm.launches)

    # -- counters: warm-up (eager, capture, replay), then replays ---------
    per_call = []
    for i in range(6):
        c0 = counts()
        request(imgs[i % 3])
        torch.cuda.synchronize()
        per_call.append(tuple(b - a for a, b in zip(c0, counts())))
    log("  per call (captures, replays, eager calls, K1, K7): "
        + ", ".join(str(c) for c in per_call))
    k1, k7 = per_call[0][3:]
    want = [(0, 0, 1, k1, k7), (1, 1, 0, k1, k7)] + [(0, 1, 0, k1, k7)] * 4
    if per_call != want or k1 != 12:
        fail(f"det graph: counters a call {per_call} != {want} (12 K1)")

    # -- replayed against eager, request by request -----------------------
    gaps = {}
    for i, img in enumerate(imgs):
        eager = request(img, eager=True)
        for rep in range(2):
            got = request(img)
            for n in names:
                a, b = got[n], eager[n]
                if a.shape != b.shape or a.dtype != b.dtype:
                    fail(f"det graph: {n} {tuple(a.shape)} {a.dtype} "
                         f"against eager {tuple(b.shape)} {b.dtype}")
                d = (a.double() - b.double()).abs().max().item()
                gaps[n] = max(gaps.get(n, 0.0), d)
        if not all(torch.isfinite(got[n]).all() for n in names[:5]):
            fail("det graph: replayed outputs not finite")
    equal = [n for n, d in gaps.items() if d == 0]
    log(f"  replayed against eager, 3 requests x 2 replays: bit-equal "
        f"{', '.join(equal) or 'none'}" + "".join(
            f"; {n} largest gap {d:.3e}" for n, d in gaps.items() if d))

    # -- the head's selection and decoder: eager against a replay ---------
    args = {}
    decode = head._decode

    def spy(*a):
        args["a"] = a
        return decode(*a)

    head._decode = spy
    with _Eager():
        step(imgs[0], hw)
    del head._decode
    memory, mask_flat, valid_ratios, shapes = args["a"][:4]
    times = {"eager": [], "replay": []}
    issue = {"eager": [], "replay": []}
    with torch.inference_mode():
        key = head._graph_key(memory, shapes)
        key_s = _key_s(head, memory, shapes)
        if key not in head._graphs:
            fail("det graph: the request's key holds no graph")
        for _ in range(5):
            for mode in ("eager", "replay", "replay", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "eager":
                    head._decode(memory, mask_flat, valid_ratios, shapes)
                else:
                    head._replay(key, memory, mask_flat, valid_ratios,
                                 shapes)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                issue[mode].append(1e3 * (t1 - t0))
                times[mode].append(1e3 * (t2 - t0))
    res = {f"{m}_ms": float(np.median(times[m])) for m in times}
    res.update({f"{m}_issue_ms": float(np.median(issue[m])) for m in issue})
    log(f"  selection + decoder, median of 10 in turns: eager "
        f"{res['eager_ms']:.2f} ms (host issue {res['eager_issue_ms']:.2f}),"
        f" replay {res['replay_ms']:.2f} ms (host issue "
        f"{res['replay_issue_ms']:.2f}); the key {1e3 * key_s:.3f} ms")

    # -- a profiled request: host syncs, K1 kernels on the device ---------
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(imgs[1], hw)
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    req = [e for e in evs if e.name() == trace.REQUEST_DET]
    if len(req) != 1:
        fail(f"det graph: {len(req)} request spans in the profile")
    a, b = req[0].start_ns(), req[0].start_ns() + req[0].duration_ns()
    syncs = [e.name() for e in evs if a <= e.start_ns() <= b and e.name() in
             ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")]
    cuda = torch.autograd.DeviceType.CUDA
    k1_names = [e.name() for e in evs if e.device_type() == cuda
                and "msda_fwd_" in e.name()]
    stages = sorted({e.name() for e in evs if e.name().startswith("rscotr.")})
    log(f"  profiled request: {len(syncs)} host syncs, {len(k1_names)} K1 "
        f"kernels on the device timeline, spans {stages}")
    if len(syncs) != 10:
        fail(f"det graph: {len(syncs)} host syncs in a request, want 10")
    if len(k1_names) != 12:
        fail(f"det graph: {len(k1_names)} K1 kernels traced, want 12")
    res.update(gaps=gaps, syncs=len(syncs))
    return res


def _key_s(head, memory, shapes, n=50) -> float:
    """Host seconds of one graph key."""
    t0 = time.perf_counter()
    for _ in range(n):
        head._graph_key(memory, shapes)
    return (time.perf_counter() - t0) / n


def flagship_det_batch(rng):
    """det 1x800^2, 18 valid GT boxes padded to max_gt = 100, and the
    collate's zero-width ``dn_wide`` marker at ladder width 20."""
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


def seg_train_batch(rng, B, hw=512):
    """Seg labels as the Potsdam loader gives them: uint8 classes in [0, 5)
    with a band of the ignore index 255 (the padded border of a crop)."""
    labels = rng.integers(0, 5, (B, hw, hw)).astype(np.uint8)
    labels[:, hw - 40:] = 255
    return dict(img=rng.integers(0, 256, (B, hw, hw, 3)).astype(np.uint8),
                gt_semantic_seg=labels)


# steps per mode in deterministic_cost: enough that the quartiles of the
# host-bound det and seg steps (the matcher, the loss's host work) are
# narrower than the flag's effect (4 each read 1.05x and 1.26x for det in
# two runs)
DET_REPS = 16


def deterministic_refusals():
    """What ``torch.use_deterministic_algorithms(True)`` refuses on the
    card among the ops the port's training could reach, and what the port
    runs there: ``F.interpolate``'s antialiased bilinear backward (the seg
    loss's shrink) must raise and ``resize_linear`` take its products
    within 1e-5 of it (run off the flag); the plain bilinear backward (the
    seg loss's upsampling, the pixel decoder's resizes) must be taken; a
    float ``cumsum`` (the sine positional encoding) is logged as taken or
    refused. Returns the refused ops."""
    import torch.nn.functional as F

    from rscotr_tpu_torch.engine.infer import resize_linear
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 64, 48, 3, device="cuda", generator=g)
    d = torch.randn(2, 16, 12, 3, device="cuda", generator=g)

    def aa(t):
        return F.interpolate(t.permute(0, 3, 1, 2), size=(16, 12),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)

    def up(t):
        return F.interpolate(t.permute(0, 3, 1, 2), size=(128, 96),
                             mode="bilinear", align_corners=False
                             ).permute(0, 2, 3, 1)

    def grads(fn, t, dy):
        t = t.clone().requires_grad_()
        out = fn(t)
        return out.detach(), torch.autograd.grad(out, t, dy)[0]

    refused, taken = [], []
    with deterministic_algorithms(True):
        for name, call in (
                ("F.interpolate bilinear antialias backward",
                 lambda: grads(aa, x, d)),
                ("F.interpolate bilinear backward",
                 lambda: grads(up, x, torch.randn(2, 128, 96, 3,
                                                  device="cuda"))),
                ("torch.cumsum float32", lambda: x.cumsum(1))):
            try:
                call()
                torch.cuda.synchronize()
                taken.append(name)
            except RuntimeError as e:
                if "deterministic" not in str(e):
                    raise
                refused.append(f"{name} ({str(e).split(' does not')[0]})")
        ours = grads(lambda t: resize_linear(t, (16, 12)), x, d)
    want = grads(aa, x, d)
    err = max((a - b).abs().max().item() for a, b in zip(ours, want))
    # the pixel decoder's resize and the seg loss's upsampling keep
    # F.interpolate's plain bilinear backward under the flag
    if "F.interpolate bilinear antialias backward" not in " ".join(
            refused) or "F.interpolate bilinear backward" not in taken or \
            err > 1e-5:
        fail(f"deterministic mode: refused {refused}; resize_linear's "
             f"products against F.interpolate(antialias=True) {err:.2e}")
    log(f"  under torch.use_deterministic_algorithms(True): refused "
        f"{refused}, replaced by ops/resize.py's products (resize_linear's "
        f"shrink against F.interpolate's, output and gradient, max "
        f"{err:.2e}); ran {taken}")
    return refused


# the switches deterministic_cost times: off; --deterministic's (torch's
# default fill of new empty tensors on); the same with the fill off
DET_MODES = {"off": (False, True), "on": (True, True),
             "on, no fill": (True, False)}


def quartiles(xs):
    """(25th percentile, median, 75th percentile) of ``xs``."""
    q1, med, q3 = np.percentile(xs, (25, 50, 75))
    return float(q1), float(med), float(q3)


def apart(a, b) -> bool:
    """Whether two (q1, median, q3) quartile spans do not overlap."""
    return a[2] < b[0] or b[2] < a[0]


def deterministic_cost(steps, batches, gen, want, counters):
    """``--deterministic``'s cost: the flagship's cls, det and seg steps
    under each of ``DET_MODES``, in turns (the order of the modes rotated
    each round), ``DET_REPS`` times each in this process (CUDA events
    around the step). Under the flag every K1b and K2b launch must take its
    ordered body and no op may refuse the mode; off, none may. Per task
    each mode's quartiles; the flag's cost is called resolved where the
    quartile spans of on and off do not overlap, and the share of torch's
    fill of new tensors only where the no-fill mode's span is apart from
    both others. Returns per task the quartiles of each mode and the two
    verdicts, and the K1b / K2b launches under the flag."""
    times = {t: {m: [] for m in DET_MODES} for t in steps}
    ordered = {"K1b": 0, "K2b": 0}
    modes = list(DET_MODES)
    for r in range(DET_REPS):
        for mode in modes[r % 3:] + modes[:r % 3]:
            on, fill = DET_MODES[mode]
            with deterministic_algorithms(on, fill):
                for task in steps:
                    before = launch_counts(counters)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    lv = steps[task](batches[task], gen)
                    end.record()
                    torch.cuda.synchronize()
                    now = launch_counts(counters)
                    got = {k: now[k] - before[k] for k in now}
                    took = (got["K1b ordered"], got["K2b ordered"])
                    if {k: got[k] for k in want[task]} != want[task] or \
                            took != ((got["K1b"], got["K2b"]) if on
                                     else (0, 0)):
                        fail(f"{task} step, deterministic {on}: launches "
                             f"{got}, want {want[task]} with K1b / K2b "
                             f"{'all' if on else 'none'} on the ordered "
                             "bodies")
                    if not all(np.isfinite(float(v)) for v in lv.values()):
                        fail(f"{task} step, deterministic {on}: non-finite "
                             "loss terms")
                    times[task][mode].append(start.elapsed_time(end))
                    ordered["K1b"] += got["K1b ordered"]
                    ordered["K2b"] += got["K2b ordered"]
    res = {}
    for task, t in times.items():
        off, on, nofill = (quartiles(t[m]) for m in DET_MODES)
        flag = apart(on, off)
        fill = flag and apart(nofill, on) and apart(nofill, off)
        res[task] = dict(off_ms=off, on_ms=on, on_no_fill_ms=nofill,
                         cost_resolved=flag, fill_resolved=fill)
        span = " / ".join(
            f"{m} {q[1]:.2f} ms [{q[0]:.2f}, {q[2]:.2f}]"
            for m, q in zip(DET_MODES, (off, on, nofill)))
        log(f"  train step {task} under --deterministic's switches, median "
            f"[quartiles] of {DET_REPS} steps each in turns: {span}; on / "
            f"off {on[1] / off[1]:.3f}x, "
            + ("the quartiles apart" if flag else
               "the quartiles overlap: no cost resolved")
            + "; the fill's share: "
            + (f"{(on[1] - nofill[1]) / (on[1] - off[1]):.2f} of the cost "
               "(no-fill apart from both)" if fill else
               "unresolved (no-fill not apart from both)")
            + "; K1b / K2b on their ordered bodies, no op refused the mode")
    return res, ordered


def train_phase():
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.heads import dino_loss as dl
    from rscotr_tpu_torch.utils.config import load_cfg
    log("training phase: flagship MTL (cls + det + seg), bf16 compute, f32 "
        "params, drop path 0.2, random weights (seed 0)")
    cfg = load_cfg(FLAGSHIP_CFG)
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    step_cfg = make_step_config(cfg)
    cdn = step_cfg.cdn
    log(f"  cls mixup/cutmix {step_cfg.cls_use_augments}; CDN "
        f"{cdn.num_groups} groups x {cdn.single_pad}, pad {cdn.pad_size} + "
        f"{cdn.num_queries} matching queries; max_gt {cdn.max_gt}")
    if not step_cfg.cls_use_augments or cdn.pad_size + cdn.num_queries != 800:
        fail("flagship step config: expected augments and 200 + 600 queries")
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    names = [n for n, _ in model.named_parameters()]
    masks = task_param_masks(names)
    tasks = ("cls", "det", "seg")
    steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
             for t in tasks}
    rng = np.random.default_rng(0)
    batches = {"cls": dict(
        img=rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8),
        gt_label=rng.integers(0, 45, 16).astype(np.int32)),
        "det": flagship_det_batch(rng), "seg": seg_train_batch(rng, 4)}
    frozen = {"cls": ("bbox_head.", "neck.", "shared_encoder.", "seg_head."),
              "det": ("cls_head.", "seg_head."),
              "seg": ("cls_head.", "bbox_head.")}
    params = dict(model.named_parameters())
    # host matcher time: the LAP solves inside dino_loss
    lap = []
    solve = dl.hungarian_batched

    def timed_solve(*a):
        t0 = time.perf_counter()
        out = solve(*a)
        lap.append((time.perf_counter() - t0) * 1e3)
        return out

    dl.hungarian_batched = timed_solve
    counters = kernel_counters()
    # K3', K4 and K5 run on the quad-gather path only: K1 and K1b do their
    # work on this one
    quad = {"K3'": 0, "K4": 0, "K5": 0}
    # seg: K1 / K1b from the pixel decoder's 6 encoder layers
    want = {"det": {"K1": 12, "K1b": 12, **quad, "K2": 12, "K2b": 12},
            "cls": {"K1": 0, "K1b": 0, **quad, "K2": 12, "K2b": 12},
            "seg": {"K1": 6, "K1b": 6, **quad, "K2": 12, "K2b": 12}}
    gen = torch.Generator().manual_seed(0)
    # -- the main path's run: 2 warm-up + 10 timed steps of each task ----
    zero_counts(counters)
    times = {t: [] for t in tasks}
    peak = {t: 0.0 for t in tasks}
    per_task = {t: {} for t in tasks}
    schedule = list(tasks) * 12
    try:
        for i, task in enumerate(schedule):
            snap = {n: p.detach().clone() for n, p in params.items()
                    if n.startswith(frozen[task])}
            before = launch_counts(counters)
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lv = steps[task](batches[task], gen)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            now = launch_counts(counters)
            got = {k: now[k] - before[k] for k in counters}
            for k, v in got.items():
                per_task[task][k] = per_task[task].get(k, 0) + v
            if got != want[task]:
                fail(f"{task} step {i}: kernel launches {got} != "
                     f"{want[task]}")
            if (now["K1 vec"] - before["K1 vec"],
                    now["K1b vec"] - before["K1b vec"]) != \
                    (got["K1"], got["K1b"]):
                fail(f"{task} step {i}: a K1 or K1b launch took the lane "
                     "body")
            vals = {k: float(v) for k, v in lv.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                fail(f"{task} step {i}: non-finite loss terms {vals}")
            moved = [n for n, p in snap.items()
                     if not torch.equal(p, params[n])]
            if moved:
                fail(f"{task} step {i}: masked parameters moved: "
                     f"{moved[:5]}")
            if i >= 2 * len(tasks):
                times[task].append(ms)
                peak[task] = max(peak[task],
                                 torch.cuda.max_memory_allocated() / 2 ** 20)
            if i < 2 or i >= len(schedule) - 2:
                log(f"  step {i} {task}: {len(vals)} terms, loss "
                    f"{vals['loss']:.4f}, grad_norm {vals['grad_norm']:.3f}"
                    f", {ms:.1f} ms, launches {got}, masked "
                    f"{len(snap)} tensors bit-identical")
    finally:
        dl.hungarian_batched = solve
    launches = launch_counts(counters)
    launches["per task"] = per_task
    log(f"  launches in the main path's run ({len(schedule)} steps): "
        f"{launches}")
    det_cost, ordered = deterministic_cost(steps, batches, gen, want,
                                           counters)
    drop = dropout_train_steps(cfg, model, step_cfg, masks, batches, want,
                               counters)
    deterministic_refusals()
    launches.update({f"{k} ordered deterministic": n
                     for k, n in ordered.items()})
    # the one device-to-host copy of the matching costs, alone
    cost = torch.randn(7, 1, 100, 600, device="cuda")
    copy_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost.cpu()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    res = {}
    for task in tasks:
        med = float(np.median(times[task]))
        res[task] = dict(median_ms=med, min_ms=min(times[task]),
                         max_ms=max(times[task]), steps=len(times[task]),
                         peak_mib=peak[task])
        log(f"  train step {task}: median {med:.2f} ms over "
            f"{len(times[task])} steps (min {min(times[task]):.2f}, max "
            f"{max(times[task]):.2f}); peak memory {peak[task]:.0f} MiB")
    res["dropout"] = drop
    lap_med = float(np.median(lap[4:]))
    res["det"]["lap_ms"] = lap_med
    res["det"]["cost_copy_ms"] = float(np.median(copy_ms))
    log(f"  det host matcher: LAP {lap_med:.2f} ms median per step "
        f"(7 x 100 x 600, 18 valid rows), cost copy alone "
        f"{np.median(copy_ms):.3f} ms (1.68 MB); "
        f"{100 * lap_med / res['det']['median_ms']:.1f}% of the det step")
    return launches, res, det_cost


# rounds of the dropout steps (cls and det, p = 0 and p = DROP_P in turns),
# the first DROP_WARMUP of them untimed
DROP_ROUNDS, DROP_WARMUP = 5, 1


def dropout_train_steps(cfg, model, step_cfg, masks, batches, want,
                        counters):
    """The flagship's cls and det steps with Swin ``attn_drop_rate``, the
    shared encoder's ``dropout`` and ``ffn_drop`` at DROP_P (a model built
    from the config with them, the training phase's weights loaded)
    against the same steps at 0, each with an optimizer of its own, in
    turns: every K2 / K2b launch is a kernel launch (the counts of the main
    path's steps), and no plain window attention runs (its functions fail
    if called); median step ms (CUDA events) and peak MiB of each."""
    import copy

    import rscotr_tpu_torch.ops.window_attention as wa
    from rscotr_tpu_torch.engine.optimizer import build_optimizer
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.models.backbones.swin import WindowMSA
    mc = copy.deepcopy(cfg["model"])
    mc["backbone"]["attn_drop_rate"] = DROP_P
    layers = mc["shared_encoder"]["transformerlayers"]
    layers["attn_cfgs"]["dropout"] = layers["ffn_cfgs"]["ffn_drop"] = DROP_P
    dmodel = build_model(mc, device="cuda")
    dmodel.load_state_dict(model.state_dict())
    rates = sorted({m.attn_drop for m in dmodel.modules()
                    if isinstance(m, WindowMSA)} |
                   {m.rate for n, m in dmodel.shared_encoder.named_modules()
                    if type(m).__name__ == "Dropout"})
    if rates != [DROP_P]:
        fail(f"dropout steps: the built model's rates are {rates}")
    settings = {}
    for name, m in (("0", model), (str(DROP_P), dmodel)):
        opt = build_optimizer(cfg["optimizer"], m.named_parameters(),
                              lr_config=cfg["lr_config"],
                              grad_clip=cfg["optimizer_config"]["grad_clip"])
        settings[name] = {t: make_train_step(m, opt, t, step_cfg, masks[t])
                          for t in ("cls", "det")}
    log(f"  dropout steps: cls and det with attn_drop_rate, the encoder's "
        f"dropout and ffn_drop at {DROP_P} against 0, {DROP_ROUNDS} rounds "
        f"in turns ({DROP_WARMUP} untimed)")

    def refuse(*a, **kw):
        fail("dropout steps: a plain window attention ran")

    plain = (wa.window_attention_torch, wa.window_attention_bwd_torch)
    wa.window_attention_torch = wa.window_attention_bwd_torch = refuse
    times = {(s, t): [] for s in settings for t in ("cls", "det")}
    peak = {k: 0.0 for k in times}
    gen = torch.Generator().manual_seed(1)
    try:
        for r in range(DROP_ROUNDS):
            order = list(settings)[::1 if r % 2 == 0 else -1]
            for setting in order:
                for task in ("cls", "det"):
                    before = launch_counts(counters)
                    torch.cuda.reset_peak_memory_stats()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    lv = settings[setting][task](batches[task], gen)
                    end.record()
                    torch.cuda.synchronize()
                    now = launch_counts(counters)
                    got = {k: now[k] - before[k] for k in counters}
                    if got != want[task]:
                        fail(f"dropout {setting} {task} step: launches "
                             f"{got} != {want[task]}")
                    if not all(np.isfinite(float(v)) for v in lv.values()):
                        fail(f"dropout {setting} {task} step: non-finite "
                             "loss terms")
                    if r >= DROP_WARMUP:
                        times[(setting, task)].append(
                            start.elapsed_time(end))
                        peak[(setting, task)] = max(
                            peak[(setting, task)],
                            torch.cuda.max_memory_allocated() / 2 ** 20)
    finally:
        wa.window_attention_torch, wa.window_attention_bwd_torch = plain
    out = {}
    for (setting, task), ts in times.items():
        out[f"{task} p={setting}"] = dict(median_ms=float(np.median(ts)),
                                          peak_mib=peak[(setting, task)],
                                          launches=want[task])
    for task in ("cls", "det"):
        a, b = out[f"{task} p=0"], out[f"{task} p={DROP_P}"]
        log(f"  train step {task} with dropout {DROP_P}: median "
            f"{b['median_ms']:.2f} ms, peak {b['peak_mib']:.0f} MiB; at 0: "
            f"{a['median_ms']:.2f} ms, peak {a['peak_mib']:.0f} MiB "
            f"({DROP_ROUNDS - DROP_WARMUP} steps each, in turns; launches "
            f"{want[task]} a step in both)")
    del dmodel, settings
    return out


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True, fill: bool = True):
    """``tools/train.py --deterministic``'s switches for the duration
    (``torch.use_deterministic_algorithms``, cuDNN's deterministic
    algorithms without benchmark search), then the caller's again.
    ``fill``: ``torch.utils.deterministic.fill_uninitialized_memory``
    (torch's default, on, fills every new empty tensor under the flag)."""
    import torch.utils.deterministic as tud
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
            cudnn.benchmark, tud.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(on)
    tud.fill_uninitialized_memory = fill
    if on:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        cudnn.deterministic, cudnn.benchmark = prev[1:3]
        tud.fill_uninitialized_memory = prev[3]


def kernel_counters():
    """The wrappers whose ``launches`` count their kernels' launches."""
    from rscotr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                     ms_deform_attn_bwd)
    from rscotr_tpu_torch.ops.msda_ws import ws_bwd, ws_fwd
    from rscotr_tpu_torch.ops.scatter_mm import scatter_add_mm
    from rscotr_tpu_torch.ops.window_attention import (window_attention,
                                                       window_attention_bwd)
    return {"K1": ms_deform_attn, "K1b": ms_deform_attn_bwd,
            "K2": window_attention, "K2b": window_attention_bwd,
            "K3'": scatter_add_mm, "K4": ws_fwd, "K5": ws_bwd}


def launch_counts(counters):
    """Each kernel's count, K1's and K1b's launches on the vector body, and
    K1b's and K2b's on their ordered bodies."""
    return dict({k: c.launches for k, c in counters.items()},
                **{"K1 vec": counters["K1"].vec_launches,
                   "K1b vec": counters["K1b"].vec_launches,
                   "K1b ordered": counters["K1b"].ordered_launches,
                   "K2b ordered": counters["K2b"].ordered_launches})


def zero_counts(counters):
    for c in counters.values():
        c.launches = 0
    counters["K1"].vec_launches = counters["K1b"].vec_launches = 0
    counters["K1b"].ordered_launches = counters["K2b"].ordered_launches = 0


def aug_batch(cfg, name, seed=0):
    """The first training batch of dataset ``name`` of a composed config,
    its train pipeline and loader options as written, run over the
    config's synthetic set (or, for a config of real data, a synthetic set
    of the task at the loader's sizes): with a device-augment option the
    port's planner draws the records and its aug collate batches them."""
    from rscotr_tpu_torch.data import build_dataloaders
    from rscotr_tpu_torch.data.build import derive_dn_ladder
    from rscotr_tpu_torch.data.datasets import (SyntheticClsDataset,
                                                SyntheticDetDataset,
                                                SyntheticSegDataset)
    entry = cfg["data"][name]
    opts = entry.get("loader", {})
    train = entry["data"]["train"]
    if train["type"].startswith("Synthetic"):
        from rscotr_tpu_torch.data import build_datasets
        ds = build_datasets({name: entry})[name]
    else:
        n = 4 * entry["data"].get("samples_per_gpu", 1)
        ds = {"cls": lambda: SyntheticClsDataset(
                  length=n, img_size=opts.get("cls_src_size", 256),
                  num_classes=45, seed=seed),
              "det": lambda: SyntheticDetDataset(
                  length=n, img_size=800, num_classes=20, max_boxes=18,
                  seed=seed),
              "seg": lambda: SyntheticSegDataset(
                  length=n, img_size=opts.get("seg_size", 512),
                  num_classes=6, seed=seed)}[entry["task"]]()
        ds.pipeline_cfg = train["pipeline"]
        ds.task, ds.dataset_name = entry["task"], name
    loader = build_dataloaders({name: ds}, cfg["data"], train=True,
                               seed=seed, num_threads=4,
                               det_dn_ladder=derive_dn_ladder(cfg))[name]
    return next(iter(loader))


def augment_phase():
    """The on-device augmentation stages on the card against the same
    stages on the CPU (their plain reference there), on records the port's
    planners drew for the devaug config's synthetic sets (seeded numpy):
    cls 16 x 256^2 -> 224^2 with 2 RandAugment slots, det 1 x 800^2, seg 2
    x 512^2. Each part is fed the CPU's output of the part before it, so a
    difference is the part's own and is not carried through an op that
    amplifies it (Equalize's and AutoContrast's LUTs, the HSV hue): at most
    ``AUG_TOL[0]`` level, on at most ``AUG_TOL[1]`` of the values. Each
    whole stage end to end, as the step runs it (``run_stage``), is held to
    ``AUG_TOL`` too. The stages hold full float32 whatever the TF32 flag
    says: run again with ``allow_tf32`` on, each output is bit-equal. Then each stage's time (CUDA events, 10 runs after 3), the
    host's time to issue one, and a profile of 3 (device time, kernels and
    aten ops per call)."""
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.ops import device_augment as D
    from rscotr_tpu_torch.tools.profile_quad_seg import profile_calls
    cfg = as_written(DEVAUG_CFG)
    step_cfg = make_step_config(cfg)
    ccfg, dcfg, scfg = (step_cfg.device_aug, step_cfg.det_device_aug,
                        step_cfg.seg_device_aug)
    log(f"augment phase: {DEVAUG_CFG.split('configs/')[1]}'s planners on "
        f"its synthetic sets; {ccfg}, {dcfg}, {scfg}")
    res = {}

    def on(dev, batch):
        t = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
        return t, {k[len("aug_"):]: v for k, v in t.items()
                   if k.startswith("aug_")}

    def part(name, fn, *args):
        """``fn`` on the CPU tensors ``args`` and on their copies on the
        card; returns the CPU's output."""
        want = fn(*args)
        got = fn(*[{k: v.cuda() for k, v in a.items()} if isinstance(a, dict)
                   else a.cuda() if isinstance(a, torch.Tensor) else a
                   for a in args]).cpu()
        d = (got - want).abs()
        share = (d > 0).float().mean().item()
        log(f"  {name:<34} card vs CPU: max {d.max().item():.0f} level(s),"
            f" {100 * share:.4f}% of {d.numel()} values differ")
        if d.max().item() > AUG_TOL[0] or share > AUG_TOL[1]:
            fail(f"augment {name}: card vs CPU max {d.max().item()}, "
                 f"{share:.2e} of values differ (tolerance {AUG_TOL})")
        return want

    # -- cls: RandomResizedCrop, flip, 2 slots, erase -------------------
    batch = aug_batch(cfg, "resisc")
    img, aug = on("cpu", batch)
    x = part("cls random_resized_crop", lambda i, a: D.random_resized_crop(
        i.float(), a["crop_y"], a["crop_x"], a["crop_h"], a["crop_w"],
        ccfg.out_size), img["img"], aug)
    x = torch.where(aug["flip"][:, None, None, None], x.flip(2), x)
    for p in range(ccfg.num_policies):
        x = part(f"cls RandAugment slot {p} "
                 f"({len(set(aug['op_id'][:, p].tolist()))} ops)",
                 lambda i, a, p=p: D.apply_rand_augment_slot(
                     i, a["op_id"][:, p], a["op_m"][:, p], ccfg.fill),
                 x, aug)
    part("cls random_erase", lambda i, a: D.random_erase(
        i, a["erase_on"], a["erase_y"], a["erase_x"], a["erase_h"],
        a["erase_w"], ccfg.erase_fill, ccfg.erase_fill_std), x, aug)
    stages = {"cls": (batch, "16x256^2 -> 224^2, 2 slots")}

    # -- det: resize / crop / resize in the bucket -------------------------
    batch = aug_batch(cfg, "dior")
    out_hw = batch["out_template"].shape[1:3]
    img, aug = on("cpu", batch)
    part("det two-stage resample", lambda i, a: D.det_device_augment(
        i, a, out_hw, dcfg), img["img"], aug)
    stages["det"] = (batch, f"1x800^2 -> {out_hw[0]}x{out_hw[1]}")

    # -- seg: ratio resize + crop + flip, then photometric ------------------
    batch = aug_batch(cfg, "potsdam")
    img, aug = on("cpu", batch)
    # the photometric record made neutral: the stage is its resample alone
    neutral = dict(aug, pm_bright=torch.zeros_like(aug["pm_bright"]),
                   pm_c_pre=torch.ones_like(aug["pm_c_pre"]),
                   pm_hsv_on=torch.zeros_like(aug["pm_hsv_on"]),
                   pm_c_post=torch.ones_like(aug["pm_c_post"]))
    x = part("seg resize + crop + flip", lambda i, a: D.seg_device_augment(
        i, a, scfg), img["img"], neutral)
    part("seg photometric_distortion", lambda i, a: D.photometric_distortion(
        i, {k[3:]: v for k, v in a.items() if k.startswith("pm_")}), x, aug)
    stages["seg"] = (batch, "2x512^2")

    # -- whole stages: end to end, TF32 on, device time ---------------------
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for task, (batch, what) in stages.items():
        want = D.run_stage(task, on("cpu", batch)[0], step_cfg)
        card = on("cuda", batch)[0]

        def fn():
            return D.run_stage(task, card, step_cfg)

        got = fn()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        if not torch.equal(got, got_tf32):
            fail(f"augment {task}: the stage moved under allow_tf32")
        d = (got.cpu() - want).abs()
        ms = cuda_ms(fn, 10)
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        res[task] = dict(ms=ms, host_ms=host_ms, what=what,
                         max=d.max().item(),
                         differ=(d > 0).float().mean().item())
        log(f"  {task} stage {what}: {ms:.3f} ms (CUDA events), "
            f"{host_ms:.3f} ms to issue on the host; end to end card vs "
            f"CPU max {res[task]['max']:.0f} level(s), "
            f"{100 * res[task]['differ']:.4f}% of {d.numel()} values "
            f"differ; bit-equal with allow_tf32 on")
        if res[task]["max"] > AUG_TOL[0] or res[task]["differ"] > AUG_TOL[1]:
            fail(f"augment {task} stage end to end: card vs CPU max "
                 f"{res[task]['max']}, {res[task]['differ']:.2e} of values "
                 f"differ (tolerance {AUG_TOL})")
        profile_calls(f"augment stage {task} {what}", fn, n=3, warmup=1)
    return res


def train_cli_run(argv, name, on_start=None, on_end=None):
    """``rscotr_tpu_torch.tools.train.main(argv)`` with every count at 0
    just before and read just after. Returns the run: per iteration
    (``steps``) its task, step, launches (since the hooks of the iteration
    before), log vars, CUDA-event span, host wall and peak memory; the
    run's ``total`` launches and ``wall``; whether a parameter of the
    backbone and of each task's head ``moved`` over the run; the runner's
    ``end_step`` and ``end_opt_step``. ``on_start(runner)`` runs in the
    first hook's ``before_run``, ``on_end(runner)`` after the tool
    returns."""
    from rscotr_tpu_torch.engine import train_step as ts_mod
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.tools import train as train_cli
    counters = kernel_counters()
    steps, moved = [], {}
    watch = ("backbone.", "cls_head.", "bbox_head.", "seg_head.")

    class Probe(Hook):
        """First hook of an iteration (priority 0): the step's launches
        since ``Tail`` (priority 100) closed the iteration before."""
        priority = 0

        def before_run(self, runner):
            if on_start is not None:
                on_start(runner)
            self.first = {}
            for n, p in runner.model.named_parameters():
                top = next((w for w in watch if n.startswith(w)), None)
                if top and top not in self.first and p.requires_grad:
                    self.first[top] = (n, p.detach().clone())
            self.last = launch_counts(counters)

        def after_train_iter(self, runner):
            now = launch_counts(counters)
            steps[-1]["launches"] = {k: now[k] - self.last[k] for k in now}
            steps[-1]["step"] = runner.step
            steps[-1]["log_vars"] = dict(runner.log_vars)

        def after_run(self, runner):
            params = dict(runner.model.named_parameters())
            for top, (n, before) in self.first.items():
                moved[top] = not torch.equal(before, params[n])

    class Tail(Hook):
        priority = 100

        def after_train_iter(self, runner):
            probe.last = launch_counts(counters)

    probe = Probe()
    real_make = ts_mod.make_train_step

    def timed_make(model, optimizer, task, step_cfg, mask=None, **kw):
        step = real_make(model, optimizer, task, step_cfg, mask, **kw)

        def call(batch, generator):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            lv = step(batch, generator)
            end.record()
            steps.append(dict(task=task, events=(start, end),
                              host_ms=1e3 * (time.perf_counter() - t0),
                              peak_mib=torch.cuda.max_memory_allocated()
                              / 2 ** 20))
            return lv
        return call

    log(f"  {name}: rscotr_tpu_torch.tools.train {' '.join(argv)}")
    ts_mod.make_train_step = timed_make
    # a --deterministic run's switches end with it
    try:
        with deterministic_algorithms(
                torch.are_deterministic_algorithms_enabled()):
            zero_counts(counters)
            t0 = time.perf_counter()
            runner = train_cli.main(argv, hooks=[probe, Tail()])
            wall = time.perf_counter() - t0
            total = launch_counts(counters)
            if on_end is not None:
                on_end(runner)
            torch.cuda.synchronize()
            run = dict(steps=steps, total=total, moved=moved, wall=wall,
                       end_step=runner.step,
                       end_opt_step=runner.optimizer.step)
            del runner
    finally:
        ts_mod.make_train_step = real_make
        torch.cuda.empty_cache()
    for s in steps:
        start, end = s.pop("events")
        s["ms"] = start.elapsed_time(end)
    return run


def check_loop_run(name, run, want_tasks, first_step=1, extra=None):
    """A ``train_cli_run``: its steps in the derived task order, numbered
    from ``first_step``; each iteration's launches ``LOOP_WANT`` (every K1
    and K1b on the vector body, no quad-path kernel); every loss term and
    grad_norm finite; the run's K1 / K1b / K2 / K2b totals the steps' sum
    plus ``extra`` (the eval hook's launches)."""
    steps = run["steps"]
    if [s["task"] for s in steps] != want_tasks or \
            [s["step"] for s in steps] != list(
                range(first_step, first_step + len(want_tasks))):
        fail(f"{name}: steps {[(s['step'], s['task']) for s in steps]}, "
             f"not the derived order {want_tasks} from {first_step}")
    for s in steps:
        got = s["launches"]
        want = dict(LOOP_WANT[s["task"]], **dict.fromkeys(QUAD, 0))
        if {k: got[k] for k in want} != want or \
                (got["K1 vec"], got["K1b vec"]) != (got["K1"], got["K1b"]):
            fail(f"{name} step {s['step']} ({s['task']}): launches {got} "
                 f"!= {want}, all K1 / K1b on the vector body")
        # every loss term, their sum and grad_norm (read here, after the
        # run: the loop itself syncs only in its log hook)
        vals = {k: float(v) for k, v in s["log_vars"].items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{name} step {s['step']}: non-finite log vars {vals}")
    extra = extra or {}
    want_total = {k: sum(LOOP_WANT[t][k] for t in want_tasks)
                  + extra.get(k, 0) for k in ("K1", "K1b", "K2", "K2b")}
    total = run["total"]
    if {k: total[k] for k in want_total} != want_total or \
            any(total[k] for k in QUAD):
        fail(f"{name}: launches {total} != {want_total} (the steps' and "
             f"{extra}), no quad-path kernel")


def loop_report(name, steps, smi):
    """Per task: the median step (CUDA events around the step call, no
    host sync added) and host wall over the steps after each group's
    first, that first step, the median data_time, the peak memory. Per
    run: each group's collection (the data_time of its first step; the
    run's first also starts the loaders), the data-wait share of the
    steps' time, and that share after step 1 (the steady wait)."""
    res = {}
    starts = [i for i, s in enumerate(steps)
              if i == 0 or steps[i - 1]["task"] != s["task"]]
    for task in ("cls", "det", "seg"):
        every = [s for s in steps if s["task"] == task]
        after = [s for i, s in enumerate(steps)
                 if s["task"] == task and i not in starts]
        r = res[task] = dict(
            median_ms=float(np.median([s["ms"] for s in after])),
            median_host_ms=float(np.median([s["host_ms"] for s in after])),
            first_ms=every[0]["ms"], steps=len(after),
            median_data_ms=1e3 * float(np.median(
                [float(s["log_vars"]["data_time"]) for s in every])),
            peak_mib=max(s["peak_mib"] for s in every))
        log(f"  {name} {task} step: median {r['median_ms']:.2f} ms (CUDA "
            f"events), host {r['median_host_ms']:.2f} ms, over "
            f"{r['steps']} steps after each group's first "
            f"({r['first_ms']:.2f} ms); median data_time "
            f"{r['median_data_ms']:.3f} ms; peak memory "
            f"{r['peak_mib']:.0f} MiB  [{smi}]")
    data = [float(s["log_vars"]["data_time"]) for s in steps]
    whole = [float(s["log_vars"]["time"]) for s in steps]
    res["data_share"] = sum(data) / sum(whole)
    res["steady_share"] = sum(data[1:]) / sum(whole[1:])
    res["group_data_ms"] = [1e3 * data[i] for i in starts]
    log(f"  {name} data wait: {100 * res['data_share']:.2f}% of the "
        f"{len(steps)} steps' time, {100 * res['steady_share']:.2f}% after "
        f"step 1; the groups' collections "
        + ", ".join(f"{x:.1f}" for x in res["group_data_ms"])
        + f" ms (the first starts the loaders)  [{smi}]")
    return res


def first_launches(name, run, n_steps, extra=""):
    """The K1 / K1b / K2 / K2b launches of each task's first step and of
    the whole run, for the kernels line's paths."""
    out = {f"{name} {t} step": {
        k: next(s for s in run["steps"] if s["task"] == t)["launches"][k]
        for k in ("K1", "K1b", "K2", "K2b")} for t in ("cls", "det", "seg")}
    out[f"{name} run ({n_steps} steps{extra})"] = {
        k: run["total"][k] for k in ("K1", "K1b", "K2", "K2b")}
    return out


def as_written(path):
    """A config file composed as the train CLI composes it."""
    from rscotr_tpu_torch.data import load_data_cfg
    from rscotr_tpu_torch.utils.config import load_cfg
    return load_data_cfg(load_cfg(path), config_root=ROOT, filename=path)


def augmented(cfg) -> str:
    """The config's device-augment options that are on, or ''."""
    on = [f"{n}.{k}" for n, e in cfg["data"].items()
          for k in ("cls_device_augment", "det_device_augment",
                    "seg_device_augment") if e.get("loader", {}).get(k)]
    return "on-device augmentation " + ", ".join(on) if on else ""


def zoo_phase():
    """The zoo's paths at full width and depth, bf16 compute, random
    weights (seed 0): the paper's MTL (MlvlClsHead scheme 5, cls through
    the shared encoder), DINO-R50 (an MTL with a ResNet-50 backbone and
    the det head only) and RSCoTrSeg-R50 (the standalone segmentor with its
    own 3-level encoder). Each request and step runs with the kernel counts
    set to 0 just before it and read just after, against the counts the
    code gives; every K1 / K1b launch must take the vector body. Each path
    first runs ``ZOO_WARMUP`` untimed calls (cuDNN's algorithm search and
    the allocator's first growth fall there), checked and counted as the
    timed ones."""
    from rscotr_tpu_torch.apis import derive_cls_hw, make_step_config
    from rscotr_tpu_torch.engine import make_infer_steps
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    counters = kernel_counters()
    rng = np.random.default_rng(1)
    launches, calls, res = {}, {}, {}

    def counted(name, want, fn):
        """Run ``fn`` with every count at 0, check the launches, and return
        (fn's result, device ms by CUDA events). No zoo path launches a
        quad-path kernel."""
        want = dict(want, **dict.fromkeys(QUAD, 0))
        zero_counts(counters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        now = launch_counts(counters)
        got = {k: now[k] for k in counters}
        vec = (now["K1 vec"], now["K1b vec"])
        if got != want or vec != (got["K1"], got["K1b"]):
            fail(f"{name}: kernel launches {got} (vector body K1 {vec[0]}, "
                 f"K1b {vec[1]}) != {want}, all on the vector body")
        for k, v in got.items():
            launches.setdefault(name, {})[k] = \
                launches.get(name, {}).get(k, 0) + v
        calls[name] = calls.get(name, 0) + 1
        return out, start.elapsed_time(end)

    def report(name, times, extra=""):
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        res[name] = dict(median_ms=float(np.median(times)), n=len(times),
                         min_ms=min(times), max_ms=max(times),
                         peak_mib=peak)
        log(f"  {name}: median {res[name]['median_ms']:.2f} ms over "
            f"{len(times)} after {ZOO_WARMUP} untimed (min {min(times):.2f}, "
            f"max {max(times):.2f}); peak memory {peak:.0f} MiB; launches "
            f"per call "
            f"{ {k: v // calls[name] for k, v in launches[name].items()} }"
            f"{extra}")

    def steps_for(cfg, model, task, mask):
        opt = build_optimizer(
            cfg["optimizer"], model.named_parameters(),
            lr_config=cfg.get("lr_config"),
            grad_clip=(cfg.get("optimizer_config") or {}).get("grad_clip"))
        return make_train_step(model, opt, task, make_step_config(cfg), mask)

    def train(name, model, step, batch, n, want, watch):
        gen = torch.Generator().manual_seed(0)
        params = dict(model.named_parameters())
        before = params[watch].detach().clone()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(ZOO_WARMUP + n):
            lv, ms = counted(name, want, lambda: step(batch, gen))
            vals = {k: float(v) for k, v in lv.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                fail(f"{name}: non-finite loss terms {vals}")
            if i >= ZOO_WARMUP:
                times.append(ms)
        if torch.equal(before, params[watch]):
            fail(f"{name}: {watch} did not move")
        report(name, times, f"; loss {vals['loss']:.4f}, grad_norm "
               f"{vals['grad_norm']:.3f}, {watch} moved")

    # -- the paper MTL: MlvlClsHead scheme 5, cls 16x224^2 ----------------
    cfg = as_written(PAPER_CFG)
    hw = derive_cls_hw(cfg)
    log(f"zoo phase: paper MTL (MlvlClsHead scheme "
        f"{cfg['model']['cls_head']['scheme']}, cls_hw {hw}), cls task, "
        f"bf16, random weights (seed 0); the config as written, "
        f"{augmented(cfg)}; train batches from its planner")
    model = build_model(cfg["model"], tasks=("cls",), device="cuda",
                        generator=torch.Generator().manual_seed(0),
                        cls_hw=hw)
    n = model.cls_head.out_proj.weight.shape[1]
    if n != 16:
        fail(f"paper MTL: out_proj over {n} tokens, want 16 (4^2 at 224^2)")
    infer = make_infer_steps(model)
    img = rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        probs, ms = counted("paper MTL cls 16x224^2 request",
                            {"K1": 6, "K1b": 0, "K2": 12, "K2b": 0},
                            lambda: infer["cls"](img))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(probs.shape) != (16, 45) or not torch.isfinite(probs).all() or \
            (probs.sum(-1) - 1).abs().max() > 1e-3:
        fail(f"paper MTL cls output invalid: {tuple(probs.shape)}")
    report("paper MTL cls 16x224^2 request", times,
           "; probs (16, 45) finite, rows sum to 1")
    head = cfg["model"]["cls_head"]
    # the cls mask as the JAX package's train_model computes it
    mask = task_param_masks(
        [k for k, _ in model.named_parameters()],
        cls_uses_encoder=head.get("type") == "MlvlClsHead")["cls"]
    batch = aug_batch(cfg, "resisc")
    if batch["img"].shape != (16, 256, 256, 3) or "aug_op_id" not in batch:
        fail(f"paper MTL: cls batch {batch['img'].shape} without records")
    train("paper MTL cls 16x224^2 step", model,
          steps_for(cfg, model, "cls", mask), batch, 3,
          {"K1": 6, "K1b": 6, "K2": 12, "K2b": 12},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, probs
    torch.cuda.empty_cache()

    # -- DINO-R50: det 1x800^2 --------------------------------------------
    cfg = as_written(DINO_R50_CFG)
    log(f"zoo phase: DINO-R50 det (MTL, ResNet-50, det head), bf16, random "
        f"weights (seed 0); the config as written, {augmented(cfg)}; train "
        "batches from its planner")
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    infer = make_infer_steps(model, max_per_img=300)
    img = rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8)
    img_hw = np.array([[800, 800]], np.int32)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        (det, labels), ms = counted(
            "DINO-R50 det 1x800^2 request",
            {"K1": 12, "K1b": 0, "K2": 0, "K2b": 0},
            lambda: infer["det"](img, img_hw, np.ones((1, 4), np.float32)))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(det.shape) != (1, 300, 5) or not torch.isfinite(det).all() or \
            not bool(((labels >= 0) & (labels < 20)).all()):
        fail(f"DINO-R50 det output invalid: {tuple(det.shape)}")
    report("DINO-R50 det 1x800^2 request", times,
           "; det (1, 300, 5) finite, labels in [0, 20)")
    mask = task_param_masks([k for k, _ in model.named_parameters()])["det"]
    batch = aug_batch(cfg, "dior")
    if "aug_s2_h" not in batch:
        fail("DINO-R50: det batch without records")
    log(f"  DINO-R50 det batch: 1x800^2 source, AutoAugment program s1 "
        f"{batch['aug_s1_h'][0]}x{batch['aug_s1_w'][0]}, crop "
        f"{batch['aug_crop_h'][0]}x{batch['aug_crop_w'][0]}, s2 "
        f"{batch['aug_s2_h'][0]}x{batch['aug_s2_w'][0]} in the "
        f"{batch['out_template'].shape[1:3]} bucket, flip "
        f"{bool(batch['aug_flip_src'][0])}")
    train("DINO-R50 det 1x800^2 step", model,
          steps_for(cfg, model, "det", mask), batch, 3,
          {"K1": 12, "K1b": 12, "K2": 0, "K2b": 0},
          "shared_encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, det, labels
    torch.cuda.empty_cache()

    # -- RSCoTrSeg-R50: seg 2x512^2 ---------------------------------------
    cfg = as_written(RSEG_R50_CFG)
    log(f"zoo phase: RSCoTrSeg-R50 seg (ResNet-50, own 3-level encoder), "
        f"bf16, random weights (seed 0); the config as written, "
        f"{augmented(cfg)}; train batches from its planner")
    model = build_model(cfg["model"], device="cuda",
                        generator=torch.Generator().manual_seed(0))
    C = cfg["model"]["decode_head"]["num_queries"]
    infer = make_infer_steps(model,
                             seg_test_cfg=cfg["model"]["test_cfg"]["seg"])
    img = rng.integers(0, 256, (2, 512, 512, 3)).astype(np.uint8)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(ZOO_WARMUP + 3):
        labels, ms = counted("RSCoTrSeg-R50 seg 2x512^2 request",
                             {"K1": 6, "K1b": 0, "K2": 0, "K2b": 0},
                             lambda: infer["seg"](img))
        if i >= ZOO_WARMUP:
            times.append(ms)
    if tuple(labels.shape) != (2, 512, 512) or \
            not bool(((labels >= 0) & (labels < C)).all()):
        fail(f"RSCoTrSeg-R50 labels invalid: {tuple(labels.shape)}")
    report("RSCoTrSeg-R50 seg 2x512^2 request", times,
           f"; labels (2, 512, 512) in [0, {C}), "
           f"{labels.unique().numel()} distinct")
    # no task mask: the standalone encoder trains (ROADMAP C6)
    batch = aug_batch(cfg, "potsdam")
    if "aug_pm_hsv_on" not in batch:
        fail("RSCoTrSeg-R50: seg batch without records")
    train("RSCoTrSeg-R50 seg 2x512^2 step", model,
          steps_for(cfg, model, "seg", None), batch, 3,
          {"K1": 6, "K1b": 6, "K2": 0, "K2b": 0},
          "encoder.layers.0.ffns.0.layers.1.weight")
    del model, infer, labels
    torch.cuda.empty_cache()
    return launches, res


# the flagship's val sets: dataset -> (task, batches, images a batch)
EVAL_SETS = {"resisc": ("cls", 4, 8), "dior": ("det", 2, 4),
             "potsdam": ("seg", 2, 4)}
# K1, K2 launches per eval batch, as in serving (K1: 6 encoder + 6 decoder
# layers per det forward, the pixel decoder's 6 encoder layers per seg one;
# K2: 12 Swin blocks per backbone pass)
EVAL_WANT = {"cls": (0, 12), "det": (12, 12), "seg": (6, 12)}


def eval_phase(smi):
    """The port's evaluation on the card, in three parts. (1) The flagship
    (seed 0) saved with ``save_checkpoint`` and loaded through
    ``resolve_checkpoint(work_dir/latest.pth)`` into a model built from
    seed 1: its cls, det and seg outputs on the first val batch of each
    task equal the saver's bit for bit. (2) ``rscotr_tpu_torch.tools.
    test.main`` on that checkpoint over the whole val sets (cls 4 x 8 x
    224^2, det 2 x 4 x 800^2, seg 2 x 4 x 512^2), every count set to 0 just
    before and read just after; each infer call is counted alone too (K1 /
    K2 per batch as ``EVAL_WANT``, every K1 on the vector body, no backward
    or quad-path launch); the metric keys and values checked; per dataset
    the median batch time after one untimed batch, images/s, the loader's
    and the step's share of the wall time and the peak memory. Then the seg
    logits path (a batch that must be cropped and resized) timed once. (3)
    The tiny config's ``make_val_step`` for cls, det and seg on the CPU
    (plain versions) and on the card (kernels), float32, TF32 off, every
    log var within SLICE_TOL (relative above 1)."""
    import shutil
    import tempfile

    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.data import build_dataloaders, build_datasets
    from rscotr_tpu_torch.engine import infer as infer_mod
    from rscotr_tpu_torch.engine import (load_checkpoint, make_infer_steps,
                                         make_val_step, resolve_checkpoint,
                                         save_checkpoint)
    from rscotr_tpu_torch.engine.test import _seg_results
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools import test as test_cli
    from rscotr_tpu_torch.utils.config import load_cfg
    counters = kernel_counters()

    def counts():
        return launch_counts(counters)

    cfg = load_cfg(FLAGSHIP_CFG)
    stc = cfg["model"]["test_cfg"]["seg"]
    log("eval phase: flagship MTL, bf16, random weights (seed 0), saved and "
        "evaluated over the synthetic val sets")
    work_dir = tempfile.mkdtemp(prefix="rscotr_eval_")
    try:
        # -- 1. checkpoint round trip -------------------------------------
        datasets = build_datasets(cfg["data"], split="val")
        classes = {n: list(d.CLASSES) for n, d in datasets.items()}
        loaders = build_dataloaders(datasets, cfg["data"], train=False)
        batches = {d.task: next(iter(loaders[n]))
                   for n, d in datasets.items()}
        model = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        path = save_checkpoint(work_dir, 0, model, meta={"CLASSES": classes})
        t_save = time.perf_counter() - t0
        fresh = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        ck = load_checkpoint(resolve_checkpoint(
            os.path.join(work_dir, "latest.pth")), model=fresh)
        t_load = time.perf_counter() - t0
        if ck["path"] != path or ck["meta"]["CLASSES"] != classes:
            fail(f"checkpoint: latest.pth resolved to {ck['path']}, not "
                 f"{path}, or its CLASSES differ")
        outs = []
        for m in (model, fresh):
            steps = make_infer_steps(m, max_per_img=300, seg_test_cfg=stc)
            det = batches["det"]
            outs.append((steps["cls"](batches["cls"]["img"]),
                         *steps["det"](det["img"], det["img_hw"],
                                       det["scale_factor"]),
                         steps["seg"](batches["seg"]["img"])))
        names = ("cls probs", "det boxes", "det labels", "seg labels")
        for name, a, b in zip(names, *outs):
            if not torch.equal(a, b):
                fail(f"checkpoint round trip: {name} {tuple(a.shape)} differ "
                     f"(max abs {(a.float() - b.float()).abs().max():.3e})")
        mib = os.path.getsize(path) / 2 ** 20
        log(f"  checkpoint: {os.path.basename(path)} {mib:.1f} MiB, "
            f"{len(ck['state_dict'])} tensors, saved in {t_save:.2f} s, "
            f"loaded (strict) into a seed-1 model in {t_load:.2f} s; "
            f"{', '.join(names)} of the first val batches bit-equal")
        del model, fresh, outs, steps
        torch.cuda.empty_cache()

        # -- 2. the CLI end to end ----------------------------------------
        calls = []
        real = infer_mod.make_infer_steps

        def counted_steps(*a, **kw):
            def wrap(task, fn):
                def call(*args):
                    before = counts()
                    out = fn(*args)
                    after = counts()
                    calls.append((task, {k: after[k] - before[k]
                                         for k in after}))
                    return out
                return call
            return {t: wrap(t, f) for t, f in real(*a, **kw).items()}

        stats = {}
        out = os.path.join(work_dir, "eval_metrics.json")
        raw = os.path.join(work_dir, "raw_results.pkl")
        argv = [FLAGSHIP_CFG, os.path.join(work_dir, "latest.pth"),
                "--eval-out", out, "--work-dir", work_dir, "--out", raw]
        log(f"  rscotr_tpu_torch.tools.test {' '.join(argv)}")
        infer_mod.make_infer_steps = counted_steps
        try:
            zero_counts(counters)
            t0 = time.perf_counter()
            metrics = test_cli.main(argv, stats=stats)
            wall = time.perf_counter() - t0
            total = counts()
        finally:
            infer_mod.make_infer_steps = real
        if json.dumps(json.load(open(out)), sort_keys=True) != \
                json.dumps(metrics, sort_keys=True):
            fail("eval: --eval-out holds other metrics than main returned")
        with open(raw, "rb") as f:
            raw_results = pickle.load(f)
        det_results = raw_results["dior"]
        per_task = {}
        for task, got in calls:
            per_task[task] = per_task.get(task, 0) + 1
            want = dict.fromkeys(got, 0)
            want.update(zip(("K1", "K2"), EVAL_WANT.get(task, (-1, -1))))
            want["K1 vec"] = want["K1"]
            if got != want:
                fail(f"eval {task} batch: launches {got} != {want}")
        want_calls = {t: n for t, n, _ in EVAL_SETS.values()}
        if per_task != want_calls:
            fail(f"eval: infer calls {per_task} != {want_calls} (the seg "
                 "tiles take the on-device argmax, no logits call)")
        launches = {k: total[k] for k in counters}
        want_total = {"K1": sum(EVAL_WANT[t][0] * n for t, n in
                                want_calls.items()),
                      "K2": sum(EVAL_WANT[t][1] * n for t, n in
                                want_calls.items())}
        if total["K1 vec"] != total["K1"] or any(
                launches[k] != want_total.get(k, 0) for k in launches):
            fail(f"eval: launches {total} != {want_total}, all K1 on the "
                 "vector body, nothing else")
        log(f"  launches in the eval run: {total} (per batch K1 / K2: "
            + ", ".join(f"{t} {k1} / {k2}" for t, (k1, k2) in
                        EVAL_WANT.items())
            + f"; batches {want_calls})")

        dior = classes["dior"]
        want_keys = (["resisc.accuracy_top-1", "dior.bbox_mAP",
                      "potsdam.mIoU", "potsdam.mFscore"]
                     + [f"dior.bbox_AP_{c}" for c in dior])
        missing = [k for k in want_keys if k not in metrics]
        if missing:
            fail(f"eval: metric keys missing: {missing}")
        # 0 / 0, as mm gives it: a det class with no GT in the val set has
        # no AP (the flagship's 8 images hold all 20); a seg class the
        # model never predicts has no precision (nor F-score), its IoU 0
        gt = set(np.concatenate([a["labels"] for a in
                                 datasets["dior"].get_annotations()]))
        nan_ok = {f"dior.bbox_AP_{c}" for i, c in enumerate(dior)
                  if i not in gt}
        nan_ok |= {f"potsdam.{m}.{c}" for c in classes["potsdam"]
                   for m in ("Precision", "Fscore")
                   if metrics.get(f"potsdam.IoU.{c}") == 0.0}
        bad = [k for k, v in metrics.items()
               if not np.isfinite(v) and k not in nan_ok]
        if bad:
            fail(f"eval: non-finite metrics {bad}")
        nans = sorted(k for k in nan_ok if not np.isfinite(metrics[k]))
        log(f"  metrics: {len(metrics)} keys, finite but for 0/0 at {nans};"
            " " + ", ".join(f"{k} {metrics[k]:.4f}" for k in want_keys[:4]))

        res = {}
        for name, (task, n, bs) in EVAL_SETS.items():
            s = stats[name]
            load, infer = s["load_s"][1:], s["infer_s"][1:]
            batch_ms = [1e3 * (a + b) for a, b in zip(load, infer)]
            res[name] = dict(
                task=task, batches=n, batch_size=bs,
                median_batch_ms=float(np.median(batch_ms)),
                images_per_s=bs * len(batch_ms) / (sum(batch_ms) / 1e3),
                load_share=sum(load) / (sum(load) + sum(infer)),
                infer_share=sum(infer) / (sum(load) + sum(infer)),
                first_batch_ms=1e3 * (s["load_s"][0] + s["infer_s"][0]),
                peak_mib=s["peak_bytes"] / 2 ** 20)
            r = res[name]
            log(f"  eval {name} ({task} {n} x {bs}): median batch "
                f"{r['median_batch_ms']:.2f} ms over {len(batch_ms)} after "
                f"1 untimed ({r['first_batch_ms']:.2f} ms); "
                f"{r['images_per_s']:.1f} images/s; loader "
                f"{100 * r['load_share']:.1f}% / infer step "
                f"{100 * r['infer_share']:.1f}% of the wall time; peak "
                f"memory {r['peak_mib']:.0f} MiB  [{smi}]")
        log(f"  the CLI's whole run (model build, checkpoint load, 8 batches,"
            f" metrics) {wall:.2f} s")

        # the seg logits path: the same tiles as if cropped from 384 x 512
        # and resized back to 300 x 400 (f32 logits to the host, numpy
        # crop, bilinear resize and argmax, as the JAX package does)
        model = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
        steps = make_infer_steps(model, max_per_img=300, seg_test_cfg=stc)
        batch = dict(batches["seg"], img_hw=np.tile([[384, 512]], (4, 1)),
                     ori_hw=np.tile([[300, 400]], (4, 1)))
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = _seg_results(steps, batch, 4)
            ms = 1e3 * (time.perf_counter() - t0)
        if [p.shape for p in preds] != [(300, 400)] * 4:
            fail(f"seg logits path: label maps {[p.shape for p in preds]}")
        t0 = time.perf_counter()
        lg = steps["seg_logits"](batch["img"]).cpu()
        step_ms = 1e3 * (time.perf_counter() - t0)
        mib = lg.numel() * 4 / 2 ** 20
        res["seg logits path"] = dict(ms=ms, logits_step_ms=step_ms,
                                      logits_mib=mib)
        log(f"  seg logits path, 4 x 512^2 cropped to 384 x 512 and resized "
            f"to 300 x 400: {ms:.1f} ms a batch (second call), of which "
            f"the logits step with its f32 {tuple(lg.shape)} ({mib:.0f} MiB)"
            f" copied to the host {step_ms:.1f} ms, the rest numpy crop, "
            f"resize and argmax  [{smi}]")
        del model, steps, lg, preds
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(work_dir, ignore_errors=True)
        raise

    # -- 3. the val step, CPU vs card -------------------------------------
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = load_cfg(TINY_CFG)
    step_cfg = make_step_config(tiny)
    cpu = build_model(tiny["model"], device="cpu",
                      generator=torch.Generator().manual_seed(0))
    gpu = build_model(tiny["model"], device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    cls_b, det_b, noises = tiny_train_batches(step_cfg.cdn)
    seg_b = seg_train_batch(np.random.default_rng(6), 2, hw=64)
    vbatches = {"cls": cls_b, "det": dict(det_b, **noises[0]), "seg": seg_b}
    for task, batch in vbatches.items():
        got = {}
        for key, m in (("cpu", cpu), ("cuda", gpu)):
            before = counts()
            lv = make_val_step(m, task, step_cfg)(
                batch, torch.Generator().manual_seed(0))
            got[key] = {k: float(v) for k, v in lv.items()}
            after = counts()
            if key == "cuda" and any(after[k] != before[k] for k in
                                     ("K1b", "K2b", "K3'", "K4", "K5")):
                fail(f"val step {task}: a backward or quad kernel launched")
        worst = max(abs(got["cpu"][k] - got["cuda"][k]) /
                    max(1.0, abs(got["cpu"][k])) for k in got["cpu"])
        log(f"  val step {task}: {len(got['cpu'])} log vars, CPU vs CUDA "
            f"max err {worst:.2e} (tol {SLICE_TOL:g}, relative above 1); "
            f"loss {got['cpu']['loss']:.5f}")
        if set(got["cpu"]) != set(got["cuda"]) or not worst <= SLICE_TOL:
            fail(f"val step {task}: CPU and CUDA log vars differ")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    # kept for the tools phase, which removes the work dir
    kept = dict(work_dir=work_dir, pth=path,
                cls_scores=np.stack(raw_results["resisc"]),
                cls_labels=np.asarray([datasets["resisc"][i]["gt_label"]
                                       for i in range(len(
                                           datasets["resisc"]))]),
                accuracy=metrics["resisc.accuracy_top-1"])
    return launches, res, det_results, kept


# the serving buckets of the export phase: task -> (batch, size)
EXPORT_BUCKETS = {"cls": (16, 224), "det": (4, 800), "seg": (4, 512)}
# native AP against the numpy AP (JAX's own bound, tests/test_native.py)
NATIVE_AP_TOL = 1e-6
# served results against the live steps on the same preprocessed batches:
# the same aten ops and kernels on the same card, so labels and seg maps
# must be equal. Scores and boxes may round once more in bf16 where the
# program runs an op another way (one bf16 ulp of a logit moves a sigmoid
# score by at most 2^-8 / 4; of a normalized box coordinate, by 2^-8 of
# the image side, here at most 1000 px)
SERVE_SCORE_TOL = 2.0 ** -10
SERVE_BOX_TOL = 2.0 ** -8 * 1000
# the eval batch of each val set, painted once by --show-dir
SHOW_WANT = {"resisc": 8, "dior": 4, "potsdam": 4}
# what the serve process must not import: the model code and what builds it
MODEL_MODULES = ("rscotr_tpu_torch.models", "rscotr_tpu_torch.engine",
                 "rscotr_tpu_torch.apis", "rscotr_tpu_torch.data",
                 "rscotr_tpu_torch.utils")
# the lines of a build that failed only for want of libjpeg / libpng
MISSING_IMAGE_LIBS = re.compile(r"jpeglib\.h|png\.h|-ljpeg|-lpng")


def native_checks(det_results):
    """The host libraries built on this machine; the native AP on the eval
    phase's det results against the numpy AP. Returns the two times."""
    from rscotr_tpu_torch.data import build_datasets, native_image
    from rscotr_tpu_torch.evaluation import eval_map, native
    from rscotr_tpu_torch.utils.config import load_cfg

    st = native.available()
    if not st:
        fail(f"coco_eval.cpp did not build: {st.reason}")
    log(f"  coco_eval: {'compiled' if st.build.compiled else 'cached'} "
        f"{st.build.path.name} in {st.build.seconds:.2f} s")
    st = native_image.available()
    if st:
        from PIL import Image
        import io
        img = np.random.default_rng(5).integers(0, 256, (37, 53, 3),
                                                dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        if not np.array_equal(native_image.imdecode(buf.getvalue()), img):
            fail("native_image: a PNG decodes to other pixels than PIL's")
        log(f"  native_image: {'compiled' if st.build.compiled else 'cached'}"
            f" {st.build.path.name} in {st.build.seconds:.2f} s, a PNG "
            "decodes to PIL's pixels")
    else:
        # the reason's first line is the command, its flags -ljpeg -lpng
        line = next((ln for ln in st.reason.splitlines()[1:]
                     if MISSING_IMAGE_LIBS.search(ln)), None)
        if line is None:
            fail(f"image_core.cpp did not build: {st.reason}")
        log(f"  native_image: unavailable ({line.strip()})")

    dior = build_datasets(load_cfg(FLAGSHIP_CFG)["data"], split="val")["dior"]
    anns = dior.get_annotations()
    kw = dict(iou_thrs=[0.5, 0.75], class_names=dior.CLASSES)
    t0 = time.perf_counter()
    got = eval_map(det_results, anns, len(dior.CLASSES), use_native=True,
                   **kw)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = eval_map(det_results, anns, len(dior.CLASSES), use_native=False,
                    **kw)
    t_numpy = time.perf_counter() - t0
    if sorted(got) != sorted(want):
        fail("native AP: other keys than the numpy AP's")
    errs = [abs(got[k] - want[k]) for k in want
            if not (np.isnan(got[k]) and np.isnan(want[k]))]
    if not max(errs) <= NATIVE_AP_TOL:
        fail(f"native AP differs from numpy's by {max(errs):.2e}")
    log(f"  native AP on the eval phase's det results ({len(det_results)} "
        f"images, {len(dior.CLASSES)} classes, IoU 0.5 and 0.75): "
        f"{len(want)} keys, max |native - numpy| {max(errs):.1e} (tol "
        f"{NATIVE_AP_TOL:g}), bbox_mAP {got['bbox_mAP']:.4f}; host "
        f"{1e3 * t_native:.1f} ms against {1e3 * t_numpy:.1f} ms")
    return t_native, t_numpy


def served_vs_live(results, files, raws, steps, meta):
    """The serve CLI's results.json and PNGs against the live steps on the
    same preprocessed batches (the tool's own ``_prep``)."""
    from PIL import Image

    from rscotr_tpu_torch.tools import serve
    worst = {"score": 0.0, "box": 0.0}
    for task, tm in meta["tasks"].items():
        bs, size = tm["bs"], tm["size"]
        prepped = [serve._prep(task, r, size, meta["img_norm"], True)
                   for r in raws]
        for b0 in range(0, len(files), bs):
            chunk = prepped[b0:b0 + bs]
            valid = len(chunk)
            chunk += [chunk[-1]] * (bs - valid)
            args = [np.stack([c[i] for c in chunk]) for i in range(3)]
            out = steps[task](*(args if task == "det" else args[:1]))
            for i in range(valid):
                name = os.path.basename(files[b0 + i])
                r = results[name][task]
                if task == "cls":
                    p = out[i].float().cpu().numpy()
                    worst["score"] = max(worst["score"],
                                         abs(r["prob"] - p.max()))
                    if r["top1"] != int(p.argmax()):
                        fail(f"served {name} cls: top-1 {r['top1']} != "
                             f"{int(p.argmax())}")
                elif task == "det":
                    det = out[0][i].cpu().numpy()
                    got = np.asarray(r["boxes_xyxy_score"], np.float32)
                    if got.shape != det.shape or \
                            r["labels"] != out[1][i].cpu().tolist():
                        fail(f"served {name} det: {got.shape} boxes, labels "
                             "differ from the live step's")
                    worst["score"] = max(worst["score"], float(
                        np.abs(got[:, 4] - det[:, 4]).max()))
                    worst["box"] = max(worst["box"], float(
                        np.abs(got[:, :4] - det[:, :4]).max()))
                else:
                    H, W = raws[b0 + i].shape[:2]
                    lab = serve._resize_labels_nearest(
                        out[i].cpu().numpy(), H, W).astype(np.uint8)
                    if not np.array_equal(np.asarray(Image.open(r["png"])),
                                          lab):
                        fail(f"served {name} seg: the label PNG differs "
                             "from the live step's")
    if worst["score"] > SERVE_SCORE_TOL or worst["box"] > SERVE_BOX_TOL:
        fail(f"served results differ from the live steps: {worst}")
    return worst


def time_requests(fn, inputs, n=20, warmup=3):
    """Median CUDA-event ms of ``n`` warm calls and the peak memory they
    allocate above what was allocated before them (MiB)."""
    for _ in range(warmup):
        fn(*inputs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*inputs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    return float(np.median(times)), peak


def export_phase(smi, det_results):
    """Export and serve on the card. (1) The host libraries build here
    (``coco_eval`` must; ``image_core`` may lack libjpeg / libpng, and only
    that is passed over, printed); the native AP on the eval phase's det
    results equals the numpy AP within NATIVE_AP_TOL. (2) The serving
    phase's seeded flagship saved as a ``.pth`` and exported by the port's
    ``tools/export_model.py`` (``--device cuda --input-dtype uint8
    --check``) at the buckets cls 16 x 224^2, det 4 x 800^2, seg 4 x 512^2;
    export seconds and the artifact's bytes. (3) ``tools/serve.py`` on 8
    PNGs of mixed sizes in a process of its own that imports no model
    module, started at once; meanwhile (4) ``tools/test.py --show-dir
    --max-batches 1`` paints one batch per val set and
    ``tools/inference_one_img.py`` prints the cls class and writes its two
    PNGs. Then the served results.json and PNGs against the live steps on
    the same preprocessed batches. (5) The artifact ``--check`` loaded, in
    process: its K1 / K2 launches per request of each task (every count at
    0 just before, read just after), equal to the live requests'
    (``EVAL_WANT``, every K1 on the vector body, nothing else); artifact and
    live requests timed in turns, CUDA events, median of 20 warm calls,
    with peak memory."""
    import contextlib
    import io
    import shutil
    import tempfile

    from PIL import Image

    from rscotr_tpu_torch import export as export_mod
    from rscotr_tpu_torch.apis import derive_img_norm
    from rscotr_tpu_torch.data import build_datasets, load_data_cfg
    from rscotr_tpu_torch.engine import make_infer_steps, save_checkpoint
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools import export_model, inference_one_img
    from rscotr_tpu_torch.tools import test as test_cli
    from rscotr_tpu_torch.utils.config import load_cfg
    from rscotr_tpu_torch.utils.visualize import _raw_image
    counters = kernel_counters()
    t_phase = time.perf_counter()
    res, launches = {}, {}

    log("export phase: native host code (g++ -O3 -fPIC -std=c++17 -shared, "
        "built at first use)")
    res["native_ap_s"], res["numpy_ap_s"] = native_checks(det_results)

    cfg = load_data_cfg(load_cfg(FLAGSHIP_CFG), config_root=ROOT,
                        filename=FLAGSHIP_CFG)
    stc = cfg["model"]["test_cfg"]["seg"]
    datasets = build_datasets(cfg["data"], split="val")
    classes = {n: list(d.CLASSES) for n, d in datasets.items()}
    work = tempfile.mkdtemp(prefix="rscotr_export_")
    serve_proc = None
    try:
        # -- export ------------------------------------------------------
        model = build_model(cfg["model"], device="cuda",
                            generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(work, 0, model, meta={"CLASSES": classes})
        art = os.path.join(work, "artifact")
        argv = [FLAGSHIP_CFG, ckpt, "--out", art, "--device", "cuda",
                "--input-dtype", "uint8", "--check"]
        for t, (bs, size) in EXPORT_BUCKETS.items():
            argv += [f"--{t}-bs", str(bs), f"--{t}-size", str(size)]
        log(f"export phase: rscotr_tpu_torch.tools.export_model "
            f"{' '.join(argv[1:])}")
        # the artifact --check loads is the one timed below
        loaded, real_load = [], export_mod.load_artifact

        def keep(*a, **kw):
            loaded.append(real_load(*a, **kw))
            return loaded[-1]

        out = io.StringIO()
        t0 = time.perf_counter()
        export_mod.load_artifact = keep
        try:
            with contextlib.redirect_stdout(out):
                rc = export_model.main(argv)
        finally:
            export_mod.load_artifact = real_load
        res["export_s"] = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"  | {line}")
        if rc != 0 or out.getvalue().count(": OK") != len(EXPORT_BUCKETS):
            fail(f"export_model --check failed (exit {rc})")
        res["trace_s"] = {t: float(m) for t, m in re.findall(
            r"(\w+): traced in ([\d.]+) s", out.getvalue())}
        res["bytes"] = {f: os.path.getsize(os.path.join(art, f))
                        for f in sorted(os.listdir(art))}
        log(f"  export {res['export_s']:.1f} s in all (model load, trace, "
            f"save, --check); traced " + ", ".join(
                f"{t} {s:.2f} s" for t, s in res["trace_s"].items())
            + "; bytes " + ", ".join(f"{f} {n}" for f, n in
                                     res["bytes"].items()))

        # -- serve, in a process of its own started now -------------------
        imgs = os.path.join(work, "imgs")
        os.makedirs(imgs)
        rng = np.random.default_rng(13)
        hws = [(800, 800), (600, 800), (512, 384), (224, 224), (1000, 700),
               (333, 517), (256, 256), (768, 1024)]
        files = [os.path.join(imgs, f"img{i}.png") for i in range(len(hws))]
        for f, hw in zip(files, hws):
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                            ).save(f)
        served = os.path.join(work, "served")
        sargv = [art, imgs, "--out-dir", served, "--score-thr", "0.0"]
        code = ("import json, runpy, sys\n"
                f"sys.argv = ['serve'] + {json.dumps(sargv)}\n"
                "runpy.run_module('rscotr_tpu_torch.tools.serve', "
                "run_name='__main__')\n"
                "print('PORT_MODULES', json.dumps(sorted(m for m in "
                "sys.modules if m.startswith('rscotr_tpu_torch'))))\n")
        log(f"export phase: rscotr_tpu_torch.tools.serve {' '.join(sargv)} "
            "(a process of its own, beside the painting)")
        t_serve = time.perf_counter()
        serve_proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        # -- painting -------------------------------------------------------
        show = os.path.join(work, "painted")
        targv = [FLAGSHIP_CFG, ckpt, "--max-batches", "1", "--show-dir",
                 show, "--eval-out", os.path.join(work, "m.json")]
        log(f"export phase: rscotr_tpu_torch.tools.test {' '.join(targv)}")
        test_cli.main(targv)
        painted = {n: sorted(os.listdir(os.path.join(show, n)))
                   for n in sorted(os.listdir(show))}
        if {n: len(f) for n, f in painted.items()} != SHOW_WANT:
            fail(f"--show-dir painted {painted}")
        for n, names in painted.items():
            for f in names:
                raw = _raw_image(datasets[n], int(f.split(".")[0]))
                if Image.open(os.path.join(show, n, f)).size != \
                        (raw.shape[1], raw.shape[0]):
                    fail(f"--show-dir {n}/{f}: not the raw image's size")
        log(f"  painted {sum(SHOW_WANT.values())} images, each the raw "
            f"image's size: " + ", ".join(f"{n} {len(f)}"
                                          for n, f in painted.items()))
        one = os.path.join(work, "one")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            inference_one_img.main([FLAGSHIP_CFG, ckpt, files[1],
                                    "--out-dir", one])
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"  | {line}")
        if sorted(os.listdir(one)) != ["det_output.png", "seg_output.png"] \
                or not any(ln.startswith("[cls/resisc] class = ")
                           for ln in lines):
            fail(f"inference_one_img: wrote {os.listdir(one)}, printed "
                 f"{lines}")
        log(f"  inference_one_img on {os.path.basename(files[1])}: the cls "
            "line, det_output.png and seg_output.png")

        # -- the served results -------------------------------------------
        stdout, stderr = serve_proc.communicate(timeout=600)
        res["serve_s"] = time.perf_counter() - t_serve
        for line in stdout.splitlines():
            log(f"  | {line}")
        if serve_proc.returncode != 0:
            fail(f"serve failed ({serve_proc.returncode}):\n{stderr}")
        mods = json.loads(stdout.split("PORT_MODULES", 1)[1])
        bad = [m for m in mods if m.startswith(MODEL_MODULES)]
        if bad:
            fail(f"serve imported model code: {bad}")
        results = json.load(open(os.path.join(served, "results.json")))
        raws = [np.asarray(Image.open(f).convert("RGB"), np.uint8)
                for f in files]
        steps = make_infer_steps(
            model, max_per_img=cfg["model"]["test_cfg"]["det"]["max_per_img"],
            img_norm=derive_img_norm(cfg), seg_test_cfg=stc)
        (fns, meta), = loaded
        worst = served_vs_live(results, files, raws, steps, meta)
        log(f"  served {len(files)} PNGs of {len(set(hws))} sizes in "
            f"{res['serve_s']:.1f} s (process start, load, 3 tasks); its "
            f"port modules {mods}; results.json and the seg PNGs against "
            f"the live steps: labels and seg maps equal, max |score| "
            f"{worst['score']:.2e} (tol {SERVE_SCORE_TOL:.2e}), max |box| "
            f"{worst['box']:.2e} px (tol {SERVE_BOX_TOL:g})")
        res["served_worst"] = worst

        # -- launches and time, artifact against live ---------------------
        rng = np.random.default_rng(0)
        res["requests"] = {}
        for t, (bs, size) in EXPORT_BUCKETS.items():
            img = rng.integers(0, 256, (bs, size, size, 3), dtype=np.uint8)
            reqs = (img,) if t != "det" else (
                img, np.full((bs, 2), size, np.int32),
                np.ones((bs, 4), np.float32))
            dev_in = tuple(torch.as_tensor(x).cuda() for x in reqs)
            zero_counts(counters)
            fns[t](*dev_in)
            torch.cuda.synchronize()
            got = launch_counts(counters)
            want = dict.fromkeys(got, 0)
            want.update(zip(("K1", "K2"), EVAL_WANT[t]))
            want["K1 vec"] = want["K1"]
            log(f"  launches in one artifact {t} {bs}x{size}^2 request: "
                f"K1 {got['K1']} ({got['K1 vec']} vector body), K2 "
                f"{got['K2']} (want {EVAL_WANT[t][0]}, all vector body, "
                f"{EVAL_WANT[t][1]}; nothing else)")
            if got != want:
                fail(f"artifact {t} request: launches {got} != {want}")
            launches[f"artifact {t} {bs}x{size}^2 request"] = got
            r = {}
            for kind, fn in (("artifact", fns[t]), ("live", steps[t]),
                             ("live", steps[t]), ("artifact", fns[t])):
                ms, peak = time_requests(fn, dev_in)
                r.setdefault(kind, []).append((ms, peak))
            res["requests"][t] = r
            log(f"  latency {t} {bs}x{size}^2, median of 20 warm calls "
                "(artifact, live, live, artifact): artifact "
                + " / ".join(f"{m:.3f}" for m, _ in r["artifact"])
                + " ms against live "
                + " / ".join(f"{m:.3f}" for m, _ in r["live"])
                + f" ms; peak above the resident weights artifact "
                f"{r['artifact'][0][1]:.0f} MiB, live "
                f"{r['live'][0][1]:.0f} MiB  [{smi}]")
        del fns, steps, loaded, model
        torch.cuda.empty_cache()
    finally:
        if serve_proc is not None and serve_proc.poll() is None:
            serve_proc.kill()
            serve_proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  export phase {res['phase_s']:.1f} s")
    return launches, res


LOOP_ITERS, LOOP_RESUME = 48, 52
# launches per loop iteration, as in the training phase (det: 6 encoder + 6
# decoder MSDA layers; seg: the pixel decoder's 6 encoder layers; every
# task: 12 Swin blocks); the quad-gather kernels never
LOOP_WANT = {"cls": {"K1": 0, "K1b": 0, "K2": 12, "K2b": 12},
             "det": {"K1": 12, "K1b": 12, "K2": 12, "K2b": 12},
             "seg": {"K1": 6, "K1b": 6, "K2": 12, "K2b": 12}}


def loop_order(cfg, max_iters, k, start=0):
    """The task of each step that the port's grouped order gives the
    flagship's train loaders, derived without data or a step: stand-in
    loaders of the real lengths whose batches carry only the task, under
    the config's strategy and stand-in hooks at the checkpoint and eval
    intervals (the log hook does not bound a group); from step ``start``
    with a fresh data stream, as a resume runs."""
    from rscotr_tpu_torch.data import build_datasets
    from rscotr_tpu_torch.data.build import build_iteration_strategy
    from rscotr_tpu_torch.data.loader import MultiDataLoader
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.engine.runner import IterBasedRunner

    class Stand:
        def __init__(self, ds, n):
            self.dataset, self.n, self._epoch = ds, n, 0

        def __len__(self):
            return self.n

        def __iter__(self):
            return iter([{"img": np.zeros(0)}] * self.n)

        def set_epoch(self, epoch):
            self._epoch = epoch

    loaders = {}
    for name, ds in build_datasets(cfg["data"]).items():
        bs = cfg["data"][name]["data"].get("samples_per_gpu", 1)
        loaders[name] = Stand(ds, len(ds) // bs)
    mdl = MultiDataLoader(loaders, build_iteration_strategy(cfg, loaders))
    tasks = []
    runner = IterBasedRunner(
        {t: (lambda b, g, t=t: tasks.append(t) or {})
         for t in ("cls", "det", "seg")}, max_iters=max_iters, prefetch=0,
        start_step=start, steps_per_dispatch=k, handle_preemption=False)
    for iv in (cfg["checkpoint_config"]["interval"],
               cfg["evaluation"]["interval"]):
        runner.register_hook(type("Interval", (Hook,), {"interval": iv})())
    runner.run(mdl)
    return tasks


def loop_phase(smi):
    """The co-training loop through the port's ``tools/train.py``
    (``rscotr_tpu_torch.tools.train.main``) on the flagship config as
    written (round_robin, ``steps_per_dispatch=16``: JAX's grouped order),
    full width, bf16, random weights from seed 0, in a temporary work dir,
    ``--max-iters 48``; every count set to 0 just before and read just
    after (``train_cli_run``). Checked (``check_loop_run``): the task of
    each step against ``loop_order`` (16 cls, 16 det, 16 seg), each
    iteration's K1 / K1b / K2 / K2b launches against ``LOOP_WANT`` (every
    K1 and K1b on the vector body, no quad-path kernel), every loss term
    and grad_norm finite, the run's totals those of its steps and its eval;
    the backbone and every head moved; ``iter_48.pth``,
    ``last_checkpoint``, ``best_checkpoint.pth`` and the ``metrics.jsonl``
    lines of the log interval (5) and the last step; the eval hook at step
    48 over the whole val sets with the eval phase's per-batch counts and
    the metric keys. Then ``--resume-from iter_48.pth --max-iters 52
    --no-validate``: the model and the optimizer state at the start equal
    the file bit for bit, the run starts at step 48 with the optimizer's
    schedule clock at 48, and 4 cls steps follow, checked as above.
    Reported: ``loop_report``; the checkpoint save and load times, the
    eval hook's time, the phase's."""
    import shutil
    import tempfile

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.engine import checkpoint as ck_mod
    from rscotr_tpu_torch.engine import hooks as hooks_mod
    from rscotr_tpu_torch.engine import infer as infer_mod
    from rscotr_tpu_torch.utils.config import load_cfg
    t_phase = time.perf_counter()
    counters = kernel_counters()
    cfg = load_cfg(FLAGSHIP_CFG)
    K = cfg["runner"]["steps_per_dispatch"]
    want_tasks = loop_order(cfg, LOOP_ITERS, K)
    if want_tasks != ["cls"] * 16 + ["det"] * 16 + ["seg"] * 16:
        fail(f"loop: the grouped order derives {want_tasks}")
    log(f"loop phase: rscotr_tpu_torch.tools.train on the flagship config "
        f"(steps_per_dispatch {K}, round_robin), bf16, random weights "
        f"(seed 0), {LOOP_ITERS} iterations, then a resume to "
        f"{LOOP_RESUME}; derived order: 16 cls, 16 det, 16 seg")

    evals, saves, loads, infer_calls, start = [], [], [], [], {}
    real_save, real_load = hooks_mod.save_checkpoint, ck_mod.load_checkpoint
    real_eval, real_infer = apis.make_eval_fn, infer_mod.make_infer_steps

    def snapshot(runner):
        start.update(step=runner.step, opt_step=runner.optimizer.step,
                     model={k: v.detach().to("cpu", copy=True) for k, v in
                            runner.model.state_dict().items()},
                     opt=runner.optimizer.state_dict())

    def timed(fn, out):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            out.append(time.perf_counter() - t0)
            return r
        return call

    def timed_eval(*a, **kw):
        return timed(real_eval(*a, **kw), evals)

    def counted_infer(*a, **kw):
        def wrap(task, fn):
            def call(*args):
                before = launch_counts(counters)
                out = fn(*args)
                after = launch_counts(counters)
                infer_calls.append((task, {k: after[k] - before[k]
                                           for k in after}))
                return out
            return call
        return {t: wrap(t, f) for t, f in real_infer(*a, **kw).items()}

    work_dir = tempfile.mkdtemp(prefix="rscotr_loop_")
    hooks_mod.save_checkpoint = timed(real_save, saves)
    ck_mod.load_checkpoint = timed(real_load, loads)
    apis.make_eval_fn = timed_eval
    infer_mod.make_infer_steps = counted_infer
    try:
        first = train_cli_run([FLAGSHIP_CFG, "--work-dir", work_dir,
                               "--max-iters", str(LOOP_ITERS)], "loop")
        first["infer"] = infer_calls[:]
        ckpt = os.path.join(work_dir, f"iter_{LOOP_ITERS}.pth")
        for f in (f"iter_{LOOP_ITERS}.pth", "last_checkpoint",
                  "best_checkpoint.pth", "metrics.jsonl", "train.log"):
            if not os.path.isfile(os.path.join(work_dir, f)):
                fail(f"loop: {f} missing from the work dir")
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)

        infer_calls.clear()
        resumed = train_cli_run(
            [FLAGSHIP_CFG, "--work-dir", work_dir, "--max-iters",
             str(LOOP_RESUME), "--resume-from", ckpt, "--no-validate"],
            "loop resume", on_start=snapshot)
        model_equal = all(torch.equal(start["model"][k], v)
                          for k, v in saved["state_dict"].items()) and \
            sorted(start["model"]) == sorted(saved["state_dict"])
        so, po = saved["optimizer"], start["opt"]
        opt_equal = so["step"] == po["step"] and so["count"] == po["count"] \
            and all(torch.equal(po[p][k], v) for p in ("mu", "nu")
                    for k, v in so[p].items())
        del saved, start["model"], start["opt"]
    finally:
        hooks_mod.save_checkpoint = real_save
        ck_mod.load_checkpoint = real_load
        apis.make_eval_fn = real_eval
        infer_mod.make_infer_steps = real_infer
        shutil.rmtree(work_dir, ignore_errors=True)
        torch.cuda.empty_cache()

    # -- the first run ----------------------------------------------------
    infer_total = {k: sum(c[k] for _, c in first["infer"])
                   for k in ("K1", "K2")}
    check_loop_run("loop", first, want_tasks, extra=infer_total)
    if not first["moved"] or not all(first["moved"].values()):
        fail(f"loop: parameters moved {first['moved']}")
    for i in (0, 16, 32, 47):
        s = first["steps"][i]
        vals = {k: float(v) for k, v in s["log_vars"].items()}
        loss = next(v for k, v in vals.items() if k.endswith(".loss"))
        log(f"  loop step {s['step']} {s['task']}: {len(vals) - 2} log vars,"
            f" loss {loss:.4f}, grad_norm {vals['grad_norm']:.3f}, "
            f"launches {s['launches']}")
    log(f"  launches in the loop run (48 steps and the eval at 48): "
        f"{first['total']}; eval {infer_total}")

    # -- logs, checkpoints, eval ------------------------------------------
    want_lines = list(range(5, LOOP_ITERS, 5)) + [LOOP_ITERS]
    if [x["step"] for x in lines] != want_lines:
        fail(f"loop: metrics.jsonl steps {[x['step'] for x in lines]} != "
             f"{want_lines}")
    bad = [(x["step"], k) for x in lines for k, v in x.items()
           if isinstance(v, float) and not k.startswith("val/")
           and not np.isfinite(v)]
    if bad:
        fail(f"loop: non-finite logged values {bad}")
    want_keys = {"val/resisc.accuracy_top-1", "val/dior.bbox_mAP",
                 "val/potsdam.mIoU", "val/potsdam.mFscore"}
    if not want_keys <= set(lines[-1]):
        fail(f"loop: eval keys missing at step 48: "
             f"{want_keys - set(lines[-1])}")
    per_task = {}
    for task, got in first["infer"]:
        per_task[task] = per_task.get(task, 0) + 1
        want = dict.fromkeys(got, 0)
        want.update(zip(("K1", "K2"), EVAL_WANT[task]))
        want["K1 vec"] = want["K1"]
        if got != want:
            fail(f"loop eval {task} batch: launches {got} != {want}")
    want_calls = {t: n for t, n, _ in EVAL_SETS.values()}
    if per_task != want_calls or len(evals) != 1:
        fail(f"loop: the eval hook ran {len(evals)} times over {per_task} "
             f"batches, not once over {want_calls}")
    log(f"  eval hook at step {LOOP_ITERS}: {sum(want_calls.values())} "
        f"batches {per_task}, per batch K1 / K2 as the eval phase; "
        + ", ".join(f"{k} {lines[-1][k]:.4f}" for k in sorted(want_keys)))

    # -- the resume ---------------------------------------------------------
    if not (model_equal and opt_equal):
        fail(f"loop resume: model bit-equal {model_equal}, optimizer state "
             f"bit-equal {opt_equal}")
    if (start["step"], start["opt_step"], resumed["end_step"],
            resumed["end_opt_step"]) != (LOOP_ITERS, LOOP_ITERS,
                                         LOOP_RESUME, LOOP_RESUME):
        fail(f"loop resume: start {start['step']} (optimizer step "
             f"{start['opt_step']}), end {resumed['end_step']} "
             f"({resumed['end_opt_step']})")
    check_loop_run("loop resume", resumed, ["cls"] * (LOOP_RESUME -
                                                      LOOP_ITERS),
                   first_step=LOOP_ITERS + 1)
    log(f"  resume from iter_{LOOP_ITERS}.pth: model and optimizer state "
        f"bit-equal to the file, start at step {start['step']} (the "
        f"optimizer's schedule clock {start['opt_step']}), then "
        f"{[s['task'] for s in resumed['steps']]} with launches "
        f"{resumed['steps'][0]['launches']} each; {resumed['total']}")

    # -- times ---------------------------------------------------------------
    res = loop_report("loop", first["steps"], smi)
    res["save_s"] = list(saves)
    res["load_s"] = list(loads)
    res["eval_s"] = evals[0]
    res["run_s"], res["resume_s"] = first["wall"], resumed["wall"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  loop checkpoint saves "
        + ", ".join(f"{x:.2f}" for x in saves) + " s (best_checkpoint, "
        f"iter_48, iter_52: the eval hook fires first), resume load "
        + ", ".join(f"{x:.2f}" for x in loads) + f" s; eval hook "
        f"{evals[0]:.2f} s; run {first['wall']:.1f} s, resume "
        f"{resumed['wall']:.1f} s, phase {res['phase_s']:.1f} s  [{smi}]")
    return first_launches("flagship loop", first, LOOP_ITERS,
                          " + eval"), res


def aug_loop_phase(smi, stages):
    """Co-training with the paper's augmentation through the port's
    ``tools/train.py``: ``MTL_synthetic_flagship_devaug.py`` (the three
    augment tails in the steps, on the card) and
    ``MTL_synthetic_flagship_hostaug.py`` (the same tails on the host, PIL
    in the loader threads), each as written (``steps_per_dispatch`` 16)
    for 48 iterations in the grouped order (16 cls, 16 det, 16 seg), in
    the order hostaug, devaug, hostaug (the devaug run between the two);
    ``--no-validate`` in a temporary work dir, full width, bf16, random
    weights from seed 0. Each run is checked by ``check_loop_run`` and its
    backbone and every head must move; reported by ``loop_report``, then
    the two configs side by side: each task's median step and the steady
    data wait (after step 1, whose collection also starts the loaders).
    Last, each augment stage's time (``augment_phase``) as a share of its
    task's devaug step."""
    import shutil
    import tempfile

    launches, res = {}, {"devaug": [], "hostaug": []}
    paths = {"devaug": DEVAUG_CFG, "hostaug": HOSTAUG_CFG}
    for name in ("hostaug", "devaug", "hostaug"):
        path = paths[name]
        cfg = as_written(path)
        k = cfg["runner"]["steps_per_dispatch"]
        want_tasks = loop_order(cfg, AUG_ITERS, k)
        n = AUG_ITERS // 3
        if want_tasks != ["cls"] * n + ["det"] * n + ["seg"] * n:
            fail(f"{name} loop: the grouped order derives {want_tasks}")
        log(f"{name} loop phase (run {len(res[name]) + 1}): "
            f"{os.path.relpath(path, ROOT)} as written "
            f"({augmented(cfg) or 'augmentation on the host'}), "
            f"steps_per_dispatch {k}, bf16, random weights (seed 0), "
            f"{AUG_ITERS} iterations: {n} cls, {n} det, {n} seg")
        work_dir = tempfile.mkdtemp(prefix=f"rscotr_{name}_")
        try:
            run = train_cli_run([path, "--work-dir", work_dir, "--max-iters",
                                 str(AUG_ITERS), "--no-validate"],
                                f"{name} loop")
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        check_loop_run(f"{name} loop", run, want_tasks)
        if not run["moved"] or not all(run["moved"].values()):
            fail(f"{name} loop: parameters moved {run['moved']}")
        for i in (0, n, 2 * n):
            s = run["steps"][i]
            log(f"  {name} loop step {s['step']} {s['task']}: loss "
                + ", ".join(f"{k} {float(v):.4f}" for k, v in
                            s["log_vars"].items() if k.endswith(".loss"))
                + f", grad_norm {float(s['log_vars']['grad_norm']):.3f}, "
                f"launches {s['launches']}")
        r = loop_report(f"{name} loop", run["steps"], smi)
        r["wall_s"] = run["wall"]
        log(f"  {name} loop run {run['wall']:.1f} s; {run['total']}; moved "
            f"{run['moved']}")
        res[name].append(r)
        if len(res[name]) == 1:
            launches.update(first_launches(f"{name} loop", run, AUG_ITERS))
    for t in ("cls", "det", "seg"):
        log(f"  {t} step, devaug against hostaug (run 2 against 1, 3): "
            + " / ".join(f"{r[t]['median_ms']:.2f}" for r in res["devaug"])
            + " ms against "
            + " / ".join(f"{r[t]['median_ms']:.2f}" for r in res["hostaug"])
            + f" ms  [{smi}]")
    log("  steady data wait (after step 1), devaug against hostaug: "
        + " / ".join(f"{100 * r['steady_share']:.2f}%"
                     for r in res["devaug"]) + " against "
        + " / ".join(f"{100 * r['steady_share']:.2f}%"
                     for r in res["hostaug"])
        + "; first collections "
        + " / ".join(f"{r['group_data_ms'][0]:.1f}" for r in res["devaug"])
        + " against "
        + " / ".join(f"{r['group_data_ms'][0]:.1f}" for r in res["hostaug"])
        + f" ms  [{smi}]")
    for t, st in stages.items():
        st["step_share"] = st["ms"] / res["devaug"][0][t]["median_ms"]
        log(f"  {t} augment stage {st['what']}: {st['ms']:.3f} ms, "
            f"{100 * st['step_share']:.1f}% of the devaug {t} step's "
            f"{res['devaug'][0][t]['median_ms']:.2f} ms  [{smi}]")
    res["stages"] = stages
    return launches, res


def soak_leg(argv) -> int:
    """``chip_smoke.py --soak-leg TRAIN_ARGV...``: one leg of the soak
    phase, the train tool through ``train_cli_run`` (every count at 0 just
    before it, read just after), its run appended as one JSON line to the
    work dir's ``legs.jsonl``."""
    work_dir = argv[argv.index("--work-dir") + 1]
    run = train_cli_run(argv, "soak leg")
    for st in run["steps"]:
        st["log_vars"] = {k: float(v) for k, v in st["log_vars"].items()}
    with open(os.path.join(work_dir, "legs.jsonl"), "a") as f:
        f.write(json.dumps(run) + "\n")
    return 0


def last_record_step(path) -> int:
    """The step of the last whole line of a ``metrics.jsonl`` (0 while it
    has none)."""
    try:
        with open(path) as f:
            lines = [x for x in f if x.endswith("\n") and x.strip()]
    except OSError:
        return 0
    return json.loads(lines[-1])["step"] if lines else 0


def soak_phase(smi):
    """The short soak through ``rscotr_tpu_torch.tools.soak_flagship``'s
    ``soak`` (module docstring, 16b). Returns the legs' launches for the
    kernels line and the phase's result."""
    import shutil
    import tempfile

    from rscotr_tpu_torch.tools import soak_flagship as sf
    from rscotr_tpu_torch.utils.config import merge_from_dict
    t_phase = time.perf_counter()
    options = (f"evaluation.interval={SOAK_EVAL}",
               "checkpoint_config.interval=100000",
               f"log_config.interval={SOAK_LOG}")
    cfg = merge_from_dict(as_written(DEVAUG_CFG), {
        "evaluation.interval": SOAK_EVAL,
        "checkpoint_config.interval": 100000})
    K = cfg["runner"].get("steps_per_dispatch", 1)
    log(f"soak phase: rscotr_tpu_torch.tools.soak_flagship.soak on "
        f"{os.path.relpath(DEVAUG_CFG, ROOT)}, {SOAK_ITERS} iterations, "
        f"--cfg-options {' '.join(options)}, steps_per_dispatch {K}; "
        f"SIGTERM {SOAK_KILL_DELAY:g} s after phase 1's record at step "
        f">= {SOAK_EVAL}; each leg a process of its own (chip_smoke.py "
        "--soak-leg)")
    work = tempfile.mkdtemp(prefix="rscotr_soak_")
    wd = os.path.join(work, "wd")
    metrics = os.path.join(wd, "metrics.jsonl")
    seen = {}

    def kill_when():
        if "at" not in seen:
            if last_record_step(metrics) >= SOAK_EVAL:
                seen["at"] = time.perf_counter()
            return False
        return time.perf_counter() - seen["at"] >= SOAK_KILL_DELAY

    try:
        res = sf.soak(wd, SOAK_ITERS, None, device="cuda", cfg=DEVAUG_CFG,
                      cfg_options=options, kill_when=kill_when,
                      command=[sys.executable, os.path.abspath(__file__),
                               "--soak-leg"], grace_s=300,
                      out=lambda line: log("  " + line))
        if res["rc"]:
            fail("soak: the protocol failed (its lines above)")
        with open(os.path.join(wd, "legs.jsonl")) as f:
            runs = [json.loads(x) for x in f]
        records = sf.read_records(wd)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    n = res["resumed_from"]
    legs = res["legs"]
    if not SOAK_EVAL < n < SOAK_ITERS or len(runs) != 2:
        fail(f"soak: preemption checkpoint iter_{n}, {len(runs)} leg "
             f"records; want {SOAK_EVAL} < N < {SOAK_ITERS} and two legs")
    if (legs[0].rc, legs[1].rc) != (sf.TIMEOUT_RC, 0):
        fail(f"soak: leg rcs {legs[0].rc}, {legs[1].rc}")
    evals = {k: sum(n_b * EVAL_WANT[t][i] for t, n_b, _ in
                    EVAL_SETS.values()) for i, k in enumerate(("K1", "K2"))}
    for i, (run, first) in enumerate(zip(runs, (0, n))):
        name = f"soak phase {i + 1}"
        want = loop_order(cfg, SOAK_ITERS, K, start=first)
        if i == 0:
            want = want[:n]
        if run["end_step"] != (n, SOAK_ITERS)[i]:
            fail(f"{name}: ended at step {run['end_step']}")
        # each leg evaluates once: at 48 before its SIGTERM, at 96
        check_loop_run(name, run, want, first_step=first + 1, extra=evals)
        if not run["moved"] or not all(run["moved"].values()):
            fail(f"{name}: parameters moved {run['moved']}")
    # phase 1's records up to N, phase 2's after it: each log step once
    steps = [r["step"] for r in records]
    want_steps = list(range(SOAK_LOG, SOAK_ITERS + 1, SOAK_LOG))
    bad = [(r["step"], k) for r in records for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)
           and not k.startswith("val/")]
    if steps != want_steps or res["summary"]["evals"] < 2 or bad:
        fail(f"soak: records at steps {steps} (want {want_steps}), "
             f"{res['summary']['evals']} val/ records, non-finite {bad}")
    log(f"  soak: preemption at iter {n}, resumed from it to {SOAK_ITERS}; "
        f"launches per iteration the devaug loop's in both legs ("
        + "; ".join(f"phase {i + 1} {r['total']}" for i, r in
                    enumerate(runs)) + f"); records at {steps}, val/ at "
        f"{res['summary']['eval_steps']}  [{smi}]")
    loop_report("soak phase 1 (beside the overfit proof)", runs[0]["steps"],
                smi)
    out = dict(n=n, summary=res["summary"],
               legs=[leg.wall_s for leg in legs],
               phase_s=time.perf_counter() - t_phase)
    log(f"  soak phase {out['phase_s']:.1f} s (legs "
        + ", ".join(f"{x:.1f}" for x in out["legs"]) + f" s)  [{smi}]")
    launches = {f"soak phase {i + 1} ({r['end_step'] - first} steps + "
                f"eval)": {k: r["total"][k] for k in K4}
                for i, (r, first) in enumerate(zip(runs, (0, n)))}
    return launches, out


# the scale-out phase: 12 round-robin iterations of the flagship a run,
# and for each task a one-step run that starts with it
# (``iteration_strategy.start_idx``), so that every task's first step runs
# from the seed's weights in every configuration. Those first steps are
# held to the training-parity tolerances (the same weights and global
# batch: only the per-rank batch's kernel tilings and K1b's atomic order
# differ), and so are their gradients, leaf by leaf: the first moment
# after one step is (1 - b1) times the clipped gradient, which Adam's
# sign-like first update does not amplify. A leaf passes when
# |mu - mu_ref| <= MU_RTOL * |mu_ref| + MU_ATOL * |all of mu_ref| (L2
# norms). One rank against the plain run, the same arithmetic, parts by
# up to 1.5e-2 in a leaf that holds 1e-3 of the norm or more, and by up to
# 7.3% in a smaller one (the atomic adds of the backward, K1b's and the
# bilinear resize's, under bf16 rounding; NVIDIA H100 80GB HBM3, 700 W),
# two ranks against the twin by as much; a leaf whose gradient one rank
# alone holds (not summed) is off by about half its norm, caught while it
# holds more than MU_ATOL / 0.4 of the norm. The later steps
# of the 12-step runs are not held to a bound: the plain run against a
# second plain run (the same code and arithmetic) parts by up to 145%
# within 12 steps (K1b's atomics move a gradient's last bits, Adam turns a
# flipped near-zero gradient into a +-lr step, det's top-k and matching
# are discrete), so they are reported beside that floor
SCALE_ITERS = 12
FIRST = {"cls": 0, "det": 1, "seg": 2}
MU_RTOL, MU_ATOL = 0.1, 2e-5


def _float_logs(lv):
    return {k: float(v) for k, v in lv.items()}


def scaleout_rank(argv) -> int:
    """One rank of the scale-out phase, started by ``torch.distributed.run
    ... chip_smoke.py --scaleout-rank SPEC``: each run of SPEC's ``runs``
    through the port's tool with ``--launcher pytorch`` (train: through
    ``train_cli_run``, the gradient sums timed with CUDA events, the
    gathered final state written by rank 0 where asked; test: each infer
    call's launches counted), then this rank's record as JSON."""
    from rscotr_tpu_torch.engine import infer as infer_mod
    from rscotr_tpu_torch.engine.checkpoint import full_state_dict
    from rscotr_tpu_torch.parallel import ddp, mesh
    from rscotr_tpu_torch.tools import test as test_cli
    with open(argv[0]) as f:
        spec = json.load(f)
    counters = kernel_counters()
    syncs = []
    real_sync = ddp.GradSync.__call__

    def timed_sync(self, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        real_sync(self, *a, **kw)
        end.record()
        syncs.append(((start, end), time.perf_counter() - t0))

    ddp.GradSync.__call__ = timed_sync
    out = {"runs": []}
    for run in spec["runs"]:
        rec = {"name": run["name"]}
        if run["tool"] == "train":
            syncs.clear()

            def keep_state(runner):
                state = full_state_dict(runner.model)
                if mesh.rank() == 0:
                    torch.save(state, run["state_out"])
            res = train_cli_run(run["argv"], run["name"], on_end=keep_state
                                if run.get("state_out") else None)
            torch.cuda.synchronize()
            for s in res["steps"]:
                s["log_vars"] = _float_logs(s["log_vars"])
            rec.update(steps=res["steps"], total=res["total"],
                       wall=res["wall"], end_step=res["end_step"],
                       sync_ms=[a.elapsed_time(b) for (a, b), _ in syncs],
                       sync_host_ms=[1e3 * h for _, h in syncs])
        else:
            calls = []
            real_infer = infer_mod.make_infer_steps

            def counted(*a, **kw):
                def wrap(task, fn):
                    def call(*args):
                        before = launch_counts(counters)
                        r = fn(*args)
                        after = launch_counts(counters)
                        calls.append((task, {k: after[k] - before[k]
                                             for k in after}))
                        return r
                    return call
                return {t: wrap(t, f) for t, f in real_infer(*a, **kw)
                        .items()}
            infer_mod.make_infer_steps = counted
            try:
                zero_counts(counters)
                t0 = time.perf_counter()
                rec["metrics"] = test_cli.main(run["argv"])
                rec["wall"] = time.perf_counter() - t0
            finally:
                infer_mod.make_infer_steps = real_infer
            rec["calls"] = calls
        rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        out["runs"].append(rec)
        torch.cuda.empty_cache()
    out.update(rank=mesh.rank(), world=mesh.world_size(),
               backend=torch.distributed.get_backend(),
               device=str(torch.cuda.current_device()))
    with open(spec["out"].format(rank=mesh.rank()), "w") as f:
        json.dump(out, f)
    mesh.destroy_distributed()
    return 0


def launch_ranks(n, runs, work, name, timeout=600):
    """``torch.distributed.run --standalone --nproc_per_node n`` of this
    script's rank mode over ``runs``; the ranks' records, rank 0 first.
    A rank that fails, or a launch past ``timeout`` seconds, fails the
    phase."""
    spec = os.path.join(work, f"{name}.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs,
                   "out": os.path.join(work, name + ".rank{rank}.out.json")},
                  f)
    log(f"  {name}: torch.distributed.run --standalone --nproc_per_node "
        f"{n} chip_smoke.py --scaleout-rank: "
        + ", ".join(r["name"] for r in runs))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), os.path.abspath(__file__),
         "--scaleout-rank", spec], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout)
    wall = time.perf_counter() - t0
    if p.returncode:
        print(p.stdout[-6000:], file=sys.stderr)
        print(p.stderr[-12000:], file=sys.stderr)
        fail(f"{name}: torch.distributed.run exited {p.returncode}")
    recs = []
    for r in range(n):
        with open(os.path.join(work, f"{name}.rank{r}.out.json")) as f:
            recs.append(json.load(f))
    log(f"  {name}: {n} rank(s) on {[x['device'] for x in recs]} over "
        f"{recs[0]['backend']}, {wall:.1f} s")
    return recs


def same_metrics(a: dict, b: dict) -> bool:
    """Equal keys and values (NaN equal to NaN)."""
    return sorted(a) == sorted(b) and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in b)


def metrics_rows(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def compare_runs(name, got, want, bound_first=True):
    """Two runs' ``metrics.jsonl`` rows, step by step: the task's summed
    loss and grad_norm, with the worst loss term beside them. The first
    row (both runs start from the seed's weights) is held to TRAIN_RTOL /
    TRAIN_ATOL when ``bound_first``. Returns the worst relative
    difference of loss and grad_norm over the rows after the first."""
    if [r["step"] for r in got] != [r["step"] for r in want]:
        fail(f"{name}: steps {[r['step'] for r in got]} vs "
             f"{[r['step'] for r in want]}")
    worst = 0.0
    skip = ("step", "time", "data_time")
    for i, (g, w) in enumerate(zip(got, want)):
        terms = [k for k in w if k not in skip and not k.startswith("val/")]
        if sorted(k for k in g if k not in skip and not k.startswith(
                "val/")) != sorted(terms):
            fail(f"{name} step {w['step']}: keys differ")
        loss = next(k for k in terms if k.endswith(".loss"))
        rel = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in terms}
        term = max((k for k in terms if k not in (loss, "grad_norm")),
                   key=rel.get, default=loss)
        log(f"    {name} step {w['step']} {loss.split('.')[0]}: loss "
            f"{g[loss]:.6f} vs {w[loss]:.6f}, grad_norm "
            f"{g['grad_norm']:.5f} vs {w['grad_norm']:.5f}; worst term "
            f"{term} {rel[term]:.1e}")
        for k in (loss, "grad_norm"):
            if i:
                worst = max(worst, rel[k])
            elif bound_first and \
                    abs(g[k] - w[k]) > TRAIN_ATOL + TRAIN_RTOL * abs(w[k]):
                fail(f"{name} step {w['step']} (from the same weights): "
                     f"{k} {g[k]:.6g} vs {w[k]:.6g} (tol {TRAIN_ATOL:g} + "
                     f"{TRAIN_RTOL:g}*|w|)")
    return worst


def first_moments(work_dir):
    """The first moment of every leaf in ``work_dir/iter_1.pth`` (the
    file memory-mapped: the weights and the second moment stay unread)."""
    ck = torch.load(os.path.join(work_dir, "iter_1.pth"), map_location="cpu",
                    weights_only=True, mmap=True)
    return {k: v.double() for k, v in ck["optimizer"]["mu"].items()}


def compare_moments(name, got, want):
    """Leaf by leaf ``got`` against ``want`` (``first_moments``'s) within
    MU_RTOL / MU_ATOL; logs the worst leaves. Returns the worst relative
    error of a leaf that holds at least 1e-3 of the whole norm."""
    if sorted(got) != sorted(want):
        fail(f"{name}: the first moments name other leaves")
    total = float(torch.sqrt(sum((v * v).sum() for v in want.values())))
    rows, bad = [], []
    for k, w in want.items():
        if got[k].shape != w.shape:
            fail(f"{name}: {k} shape {tuple(got[k].shape)} vs "
                 f"{tuple(w.shape)}")
        err = float(torch.linalg.vector_norm(got[k] - w))
        ref = float(torch.linalg.vector_norm(w))
        tol = MU_RTOL * ref + MU_ATOL * total
        rows.append((err / tol if tol else float(err > 0), err, ref, k))
        if err > tol:
            bad.append(k)
    rows.sort(reverse=True)
    worst_rel = max((e / r for _, e, r, _ in rows if r >= 1e-3 * total),
                    default=0.0)
    worst = "; ".join(f"{k} {e:.2e} of {r:.2e} ({x:.2f} of the bound)"
                      for x, e, r, k in rows[:3])
    log(f"    {name}: {len(rows)} leaves, {sum(r > 0 for *_, r, _ in rows)} "
        f"moved, |mu| {total:.4e}; worst relative error of a leaf holding "
        f">= 1e-3 of it {worst_rel:.2e}; worst against the bound: {worst}")
    if bad:
        fail(f"{name}: {len(bad)} leaves outside {MU_RTOL:g} * |ref| + "
             f"{MU_ATOL:g} * |all|, first {bad[:5]}")
    return worst_rel


def check_rank_steps(name, rec, tasks, ordered=False):
    """A rank's train run: its tasks in order and every iteration's K1 /
    K1b / K2 / K2b launches ``LOOP_WANT`` (K1 / K1b on the vector body, no
    quad-path kernel), every K1b and K2b launch on its ordered body where
    ``ordered`` (a ``--deterministic`` run), none elsewhere."""
    steps = rec["steps"]
    if [s["task"] for s in steps] != tasks:
        fail(f"{name}: tasks {[s['task'] for s in steps]} != {tasks}")
    for s in steps:
        got = s["launches"]
        want = dict(LOOP_WANT[s["task"]], **dict.fromkeys(QUAD, 0))
        want.update({"K1b ordered": want["K1b"] if ordered else 0,
                     "K2b ordered": want["K2b"] if ordered else 0})
        if {k: got[k] for k in want} != want or \
                (got["K1 vec"], got["K1b vec"]) != (got["K1"], got["K1b"]):
            fail(f"{name} step {s['step']} ({s['task']}): launches {got} "
                 f"!= {want}, all K1 / K1b on the vector body")
        if not all(np.isfinite(v) for v in s["log_vars"].values()):
            fail(f"{name} step {s['step']}: non-finite log vars")


def rank_report(name, recs, smi, label):
    """Per rank and task: the median step ms (CUDA events), its gradient
    sum's ms (CUDA events; host ms), the peak memory."""
    res = {}
    for rec in recs:
        r = rec["run"]
        n = len(r["sync_ms"])
        for task in ("cls", "det", "seg"):
            idx = [i for i, s in enumerate(r["steps"]) if s["task"] == task]
            later = idx[1:] or idx
            ms = float(np.median([r["steps"][i]["ms"] for i in later]))
            sync = float(np.median([r["sync_ms"][i] for i in later])) \
                if n == len(r["steps"]) else float("nan")
            sync_h = float(np.median([r["sync_host_ms"][i] for i in later])) \
                if n == len(r["steps"]) else float("nan")
            peak = max(r["steps"][i]["peak_mib"] for i in idx)
            res[(rec["rank"], task)] = dict(ms=ms, sync_ms=sync, peak=peak)
            log(f"  {name} rank {rec['rank']} {task} step: median {ms:.2f} "
                f"ms, gradient sum {sync:.2f} ms (host {sync_h:.2f} ms), "
                f"peak {peak:.0f} MiB, over {len(later)} steps; {label} "
                f"[{smi}]")
    return res


# the scale-out runs made with --deterministic (C17): the 12-step plain run
# and its repeat
DETERMINISTIC = ("plain", "plain2")


def bit_equal_runs(name, wd_a, wd_b, iters=SCALE_ITERS):
    """Two runs' ``metrics.jsonl`` rows equal value for value at every step
    (every loss term and grad_norm; not the clocks), and their last
    checkpoints (``iter_{iters}.pth``) equal tensor for tensor: the
    weights and the optimizer's moments."""
    a, b = metrics_rows(wd_a), metrics_rows(wd_b)
    skip = ("time", "data_time")
    if [r["step"] for r in a] != list(range(1, iters + 1)) or \
            [r["step"] for r in b] != [r["step"] for r in a]:
        fail(f"{name}: steps {[r['step'] for r in a]} / "
             f"{[r['step'] for r in b]}, not 1..{iters}")
    for ra, rb in zip(a, b):
        keys = sorted(k for k in ra if k not in skip)
        if keys != sorted(k for k in rb if k not in skip) or \
                any(ra[k] != rb[k] for k in keys):
            fail(f"{name} step {ra['step']}: "
                 + ", ".join(f"{k} {ra[k]!r} vs {rb.get(k)!r}" for k in keys
                             if ra[k] != rb.get(k)))
        loss = next(k for k in keys if k.endswith(".loss"))
        log(f"    {name} step {ra['step']} {loss.split('.')[0]}: "
            f"{len(keys) - 1} values bit-equal (loss {ra[loss]!r}, "
            f"grad_norm {ra['grad_norm']!r})")
    ck = [torch.load(os.path.join(wd, f"iter_{iters}.pth"),
                     map_location="cpu", weights_only=True, mmap=True)
          for wd in (wd_a, wd_b)]
    counts = {}
    for part in ("state_dict", "optimizer"):
        flat = [dict(_leaves(c[part])) for c in ck]
        if sorted(flat[0]) != sorted(flat[1]) or not all(
                torch.equal(v, flat[1][k]) for k, v in flat[0].items()):
            bad = [k for k, v in flat[0].items()
                   if k not in flat[1] or not torch.equal(v, flat[1][k])]
            fail(f"{name}: iter_{iters}.pth {part} differs at {bad[:5]}")
        counts[part] = len(flat[0])
    log(f"  {name}: every loss term and grad_norm of all {iters} steps "
        f"bit-equal; iter_{iters}.pth bit-equal: {counts['state_dict']} "
        f"weights, {counts['optimizer']} optimizer tensors (the first and "
        "second moments)")


# iterations of each --deterministic devaug run (two rounds of cls, det, seg)
DEVAUG_DET_ITERS = 6


def deterministic_devaug():
    """``MTL_synthetic_flagship_devaug.py`` (the bench harness's training
    config: its augment stages run on the card inside the step) through
    ``tools/train.py --deterministic`` twice, ``DEVAUG_DET_ITERS``
    round-robin iterations each (``--steps-per-dispatch 1``): no op of the
    steps or their augment stages refuses the mode (a refusal raises out of
    the step and fails the phase), every K1b and K2b launch takes its
    ordered body, and the two runs are bit-equal at every step and in
    their last checkpoint. It prints no timing (it runs beside the overfit
    proof)."""
    import shutil
    import tempfile
    want = loop_order(as_written(DEVAUG_CFG), DEVAUG_DET_ITERS, 1)
    if sorted(set(want)) != ["cls", "det", "seg"]:
        fail(f"devaug --deterministic: the order derives {want}")
    log(f"deterministic devaug: {os.path.relpath(DEVAUG_CFG, ROOT)} "
        f"(augment stages on the card) through tools/train.py "
        f"--deterministic, twice, {DEVAUG_DET_ITERS} iterations {want}")
    work = tempfile.mkdtemp(prefix="rscotr_devaug_det_")
    try:
        wds = []
        for i in (1, 2):
            wd = os.path.join(work, f"run{i}")
            run = train_cli_run(
                [DEVAUG_CFG, "--work-dir", wd, "--max-iters",
                 str(DEVAUG_DET_ITERS), "--steps-per-dispatch", "1",
                 "--no-validate", "--deterministic", "--cfg-options",
                 "log_config.interval=1"], f"devaug --deterministic {i}")
            check_rank_steps(f"devaug --deterministic {i}", dict(steps=[
                dict(s, log_vars=_float_logs(s["log_vars"]))
                for s in run["steps"]]), want, ordered=True)
            wds.append(wd)
        bit_equal_runs(f"devaug run 2 vs run 1 ({DEVAUG_DET_ITERS} steps, "
                       "--deterministic)", *wds, iters=DEVAUG_DET_ITERS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("  devaug under --deterministic: no op of the steps or their "
        "augment stages refused the mode; every K1b / K2b launch on its "
        "ordered body")


def _leaves(tree, prefix=""):
    """(dotted name, tensor) of every tensor in a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")


def scaleout_phase(smi, after_timed=None):
    """Scale-out through the port's ``--launcher pytorch`` on one card.

    (a) two ranks share the card under ``torch.distributed.run
    --nproc_per_node 2 --standalone`` over gloo (``--cfg-options
    dist_params.backend=gloo``: NCCL refuses two ranks on one device):
    ``tools/train.py`` on the flagship, 12 round-robin iterations
    (``--steps-per-dispatch 1``; cls 2x16x224^2, det 2x1x800^2, seg
    2x2x512^2), the eval hook at 12 on both ranks; a one-process twin of
    the same global batch (``samples_per_gpu`` doubled) on the same card;
    each task's first step from the seed's weights (``FIRST``) held to the
    training-parity tolerances by ``compare_runs`` and its gradients leaf
    by leaf by ``compare_moments``; the later steps beside the noise
    floor, a second plain run against the plain run; the 2-rank
    ``iter_12.pth`` loaded into one process bit-equal to rank 0's gathered
    state. (b) one rank over NCCL: DP, then FSDP (``parallel.fsdp=True``),
    against the plain one-process run the same way. (c) two-rank FSDP over
    gloo against the twin (gloo carries FSDP2's all-gather and
    reduce-scatter of CUDA tensors: a two-rank FSDP2 step over gloo on one
    NVIDIA H100 ran, torch 2.11.0+cu128). (d)
    ``tools/test.py --launcher pytorch`` on two ranks over (a)'s
    checkpoint against the one-process tool: the metrics and the seg label
    maps equal. (e) per rank and iteration the K1 / K1b / K2 / K2b launches
    (``LOOP_WANT``, the one-process loop's, on the vector body), per-rank
    step and gradient-sum ms (CUDA events) and peak memory, labelled as
    two ranks sharing one card over gloo. The cls batch augments are off
    (they pair within a rank, ROADMAP C15). ``after_timed()`` runs once
    the timed runs, (a), (b) and (c), have ended: what it starts runs
    beside the phase's untimed rest."""
    import shutil
    import tempfile

    from rscotr_tpu_torch.engine.checkpoint import load_checkpoint
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools import test as test_cli
    from rscotr_tpu_torch.utils.config import load_cfg
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="rscotr_scale_")
    tasks = ["cls", "det", "seg"] * (SCALE_ITERS // 3)
    opts = ["--cfg-options", "log_config.interval=1",
            "model.train_cfg.cls.augments=[]"]
    kinds = {"a": ["--launcher", "pytorch", "dist_params.backend=gloo"],
             "c": ["--launcher", "pytorch", "dist_params.backend=gloo",
                   "parallel.fsdp=True"],
             "b_dp": ["--launcher", "pytorch"],
             "b_fsdp": ["--launcher", "pytorch", "parallel.fsdp=True"],
             "twin": ["data.resisc.data.samples_per_gpu=32",
                      "data.dior.data.samples_per_gpu=2",
                      "data.potsdam.data.samples_per_gpu=4"],
             "plain": [], "plain2": []}

    def run(kind, first=None):
        """(name, tool argv) of a ``kind`` run: 12 iterations, or one
        starting with task ``first``."""
        name = kind if first is None else f"{kind} {first} first"
        wd = os.path.join(work, name.replace(" ", "_"))
        extra = kinds[kind]
        launcher = extra[:2] if extra[:1] == ["--launcher"] else []
        cfg_opts = extra[len(launcher):]
        iters = SCALE_ITERS if first is None else 1
        argv = [FLAGSHIP_CFG, "--max-iters", str(iters),
                "--steps-per-dispatch", "1", "--work-dir", wd] + launcher
        if kind in DETERMINISTIC and first is None:
            argv.append("--deterministic")
        if not (kind == "a" and first is None):
            argv.append("--no-validate")
        argv += opts + cfg_opts
        if first is not None:
            argv.append(f"iteration_strategy.start_idx={FIRST[first]}")
        return dict(name=name, tool="train", argv=argv, wd=wd)

    log(f"scale-out phase: the flagship through tools/train.py and "
        f"tools/test.py --launcher pytorch, {SCALE_ITERS} round-robin "
        f"iterations a run and a one-step run per task starting with it; "
        f"two ranks share one H100 over gloo, one rank over NCCL  [{smi}]")
    runs = {}
    try:
        a = run("a")
        a["state_out"] = os.path.join(work, "a_state.pt")
        ckpt = os.path.join(a["wd"], f"iter_{SCALE_ITERS}.pth")
        d = dict(name="d 2-rank eval", tool="test",
                 argv=[FLAGSHIP_CFG, ckpt, "--launcher", "pytorch", "--out",
                       os.path.join(work, "d2.pkl"), "--eval-out",
                       os.path.join(work, "d2.json"), "--cfg-options",
                       "dist_params.backend=gloo"])
        two_runs = [a, d, run("c")] + [run(k, t) for k in ("a", "c")
                                       for t in FIRST]
        two = launch_ranks(2, two_runs, work, "two_ranks")
        one_runs = [run(k, t) for k in ("b_dp", "b_fsdp")
                    for t in (None, *FIRST)]
        one_rank = launch_ranks(1, one_runs, work, "one_rank_nccl")
        if after_timed is not None:
            after_timed()
        for rec in two + one_rank:
            rec["by_name"] = {r["name"]: r for r in rec["runs"]}
        for r in [run(k, t) for k in ("twin", "plain")
                  for t in (None, *FIRST)] + [run("plain2")]:
            runs[r["name"]] = dict(r, res=train_cli_run(r["argv"], r["name"]))
        one_eval = test_cli.main([FLAGSHIP_CFG, ckpt, "--out",
                                  os.path.join(work, "d1.pkl"), "--eval-out",
                                  os.path.join(work, "d1.json")])
        for r in two_runs + one_runs:
            runs.setdefault(r["name"], r)

        # -- launches and finite values of every 12-step run ---------------
        for rec in two:
            for k in ("a", "c"):
                check_rank_steps(f"{k} rank {rec['rank']}",
                                 rec["by_name"][k], tasks)
        for k in ("b_dp", "b_fsdp"):
            check_rank_steps(k, one_rank[0]["by_name"][k], tasks)
        for k in ("twin", "plain", "plain2"):
            check_rank_steps(k, dict(steps=[
                dict(s, log_vars=_float_logs(s["log_vars"]))
                for s in runs[k]["res"]["steps"]]), tasks,
                ordered=k in DETERMINISTIC)

        def rows(name):
            return metrics_rows(runs[name]["wd"])

        # -- C17: two --deterministic runs repeat bit for bit -------------
        bit_equal_runs("plain2 vs plain (12 steps, --deterministic)",
                       runs["plain2"]["wd"], runs["plain"]["wd"])
        pairs = [("a", "twin", "a: 2 ranks (gloo)"),
                 ("c", "twin", "c: 2-rank FSDP (gloo)"),
                 ("b_dp", "plain", "b: 1-rank DP (NCCL)"),
                 ("b_fsdp", "plain", "b: 1-rank FSDP (NCCL)")]
        ref_mu = {}
        for got, want, label in pairs:
            worst_mu = 0.0
            for t in FIRST:
                compare_runs(f"{got} vs {want}, {t} first",
                             rows(f"{got} {t} first"),
                             rows(f"{want} {t} first"))
                key = f"{want} {t} first"
                if key not in ref_mu:
                    ref_mu[key] = first_moments(runs[key]["wd"])
                worst_mu = max(worst_mu, compare_moments(
                    f"{got} vs {want}, {t} first step's gradients",
                    first_moments(runs[f"{got} {t} first"]["wd"]),
                    ref_mu[key]))
            later = compare_runs(f"{got} vs {want} (12 steps)", rows(got),
                                 rows(want))
            log(f"  {label} against one process on the "
                f"{'global' if want == 'twin' else 'same'} batch: the first "
                f"step of cls, det and seg from the seed's weights within "
                f"{TRAIN_ATOL:g} + {TRAIN_RTOL:g}*|w|, its gradients leaf by "
                f"leaf within {MU_RTOL:g}*|ref| + {MU_ATOL:g}*|all| (worst "
                f"relative error of a leaf {worst_mu:.2e}); the later steps "
                f"part by up to {later:.2e} (this run on today's atomic "
                f"bodies; two --deterministic runs are bit-equal)")
        del ref_mu

        # -- (a) the checkpoint --------------------------------------------
        state = torch.load(a["state_out"], map_location="cpu",
                           weights_only=True)
        model = build_model(load_cfg(FLAGSHIP_CFG)["model"], device="cpu")
        ck = load_checkpoint(ckpt, model=model)
        equal = sorted(state) == sorted(model.state_dict()) and all(
            torch.equal(v, state[k]) for k, v in model.state_dict().items())
        if not equal or ck["meta"]["iter"] != SCALE_ITERS:
            fail("a: iter_12.pth does not load bit-equal to rank 0's "
                 "gathered state")
        log(f"  a: iter_12.pth (rank 0's write) loads into one process "
            f"bit-equal to rank 0's gathered state ({len(state)} tensors), "
            f"meta iter {ck['meta']['iter']}; the eval hook at 12 ran on "
            f"both ranks: " + ", ".join(
                f"{k} {v:.4f}" for k, v in rows("a")[-1].items()
                if k in ("val/resisc.accuracy_top-1", "val/dior.bbox_mAP",
                         "val/potsdam.mIoU")))
        del state, model, ck

        # -- (d) two-rank evaluation ------------------------------------------
        with open(os.path.join(work, "d2.json")) as f:
            m2 = json.load(f)
        with open(os.path.join(work, "d2.pkl"), "rb") as f:
            r2 = pickle.load(f)
        with open(os.path.join(work, "d1.pkl"), "rb") as f:
            r1 = pickle.load(f)
        if not same_metrics(m2, one_eval) or not same_metrics(
                two[0]["by_name"][d["name"]]["metrics"], one_eval):
            fail(f"d: 2-rank metrics {m2} != one process {one_eval}")
        raw_equal = {n: len(r2[n]) == len(r1[n]) and all(
            np.array_equal(x, y) if not isinstance(x, list) else all(
                np.array_equal(p, q) for p, q in zip(x, y))
            for x, y in zip(r2[n], r1[n])) for n in r1}
        if not raw_equal["potsdam"]:
            fail("d: 2-rank seg label maps differ from one process's")
        for rec in two:
            dr = rec["by_name"][d["name"]]
            per_task = {}
            for task, got in dr["calls"]:
                per_task[task] = per_task.get(task, 0) + 1
                want = dict.fromkeys(got, 0)
                want.update(zip(("K1", "K2"), EVAL_WANT[task]))
                want["K1 vec"] = want["K1"]
                if got != want:
                    fail(f"d rank {rec['rank']} {task} batch: launches "
                         f"{got} != {want}")
            log(f"  d rank {rec['rank']}: {per_task} batches (its strided "
                f"share), per batch K1 / K2 as the eval phase, "
                f"{dr['wall']:.1f} s")
        log(f"  d: 2-rank tools/test.py metrics equal the one-process "
            f"tool's ({len(m2)} keys: resisc.accuracy_top-1 "
            f"{m2['resisc.accuracy_top-1']}, dior.bbox_mAP "
            f"{m2['dior.bbox_mAP']}, potsdam.mIoU {m2['potsdam.mIoU']}); "
            f"raw results bit-equal: {raw_equal}")

        # -- (e) per rank ----------------------------------------------------
        label = "two ranks sharing one H100 over gloo, not a scaling figure"
        for rec in two:
            rec["run"] = rec["by_name"]["a"]
        rep = rank_report("a", two, smi, label)
        for rec in two:
            log(f"  a rank {rec['rank']} launches per iteration: " + "; ".join(
                f"{t} " + "/".join(str(next(
                    s for s in rec["run"]["steps"] if s["task"] == t)
                    ["launches"][k]) for k in ("K1", "K1b", "K2", "K2b"))
                for t in ("cls", "det", "seg"))
                + " (K1/K1b/K2/K2b, all K1 / K1b on the vector body; the "
                "one-process loop's)")
        for k in ("c",):
            rank_report(k, [dict(rank=rec["rank"], run=rec["by_name"][k])
                            for rec in two], smi, label)
        for k in ("b_dp", "b_fsdp"):
            rank_report(k, [dict(rank=0, run=one_rank[0]["by_name"][k])],
                        smi, "one rank over NCCL")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    res = dict(per_rank={f"rank {r} {t}": v for (r, t), v in rep.items()},
               phase_s=time.perf_counter() - t_phase)
    log(f"  scale-out phase {res['phase_s']:.1f} s (its runs after the "
        f"timed ones beside the overfit proof)  [{smi}]")
    return res


# -- the bench phase -------------------------------------------------------

# the keys of the root bench.py's line, when its training half ran
BENCH_LINE_KEYS = {
    "metric", "unit", "infer_img_s", "infer_vs_baseline", "mfu",
    "unit_gflops", "cls_ms", "det_ms", "seg_ms", "cls_dispatch_ms",
    "det_dispatch_ms", "seg_dispatch_ms", "device", "baseline_note",
    "value", "vs_baseline", "train_s_per_iter"}


# the graft phase: timed entry() calls (after GRAFT_WARMUP untimed), and
# entry()'s f32 output on the card against its f32 output on the CPU (the
# same seed's weights and image; TF32 off): 6 encoder and 6 decoder layers
# of f32 sums in another order, K1 / K2 against their plain versions
GRAFT_CALLS, GRAFT_WARMUP = 20, 3
GRAFT_TOL = 1e-3
# the dry run's ranks and its time limit in this script
GRAFT_RANKS, GRAFT_TIMEOUT = 4, 480


class _EncoderTap:
    """A global forward hook keeping the shared encoder's output (the
    memory the two-stage top-k reads)."""

    def __init__(self):
        from rscotr_tpu_torch.models.layers.transformer import \
            DeformableEncoder
        self.cls, self.out = DeformableEncoder, None
        self.handle = torch.nn.modules.module.register_module_forward_hook(
            self)

    def __call__(self, module, args, output):
        if isinstance(module, self.cls):
            self.out = output.detach()


def graft_phase(smi, dryrun):
    """The driver entry (``rscotr_tpu_torch/graft_entry.py``): ``entry()`` on
    the card at full width (the paper MTL, bf16, det 256^2), K1 and K2 12
    launches a call, all on the vector / tensor-core bodies, the median of
    GRAFT_CALLS calls (CUDA events); the same fn in float32 on the card
    against the CPU (a config that sets ``compute_dtype`` float32 over the
    paper MTL; the encoder memory and, where the top-k picks the same
    proposals, every output within GRAFT_TOL; the picked proposals'
    scores, sorted, always); beside it ``dryrun``, what ``finish_dryrun``
    held of the dry run's process."""
    import tempfile

    from rscotr_tpu_torch import graft_entry
    t_phase = time.perf_counter()
    log("graft phase: rscotr_tpu_torch.graft_entry.entry() (the paper MTL, "
        "bf16, det 256^2)")
    counters = kernel_counters()
    fn, (params, img, hw) = graft_entry.entry()
    for _ in range(GRAFT_WARMUP):
        fn(params, img, hw)
    torch.cuda.synchronize()
    want = {"K1": 12, "K1b": 0, "K2": 12, "K2b": 0, "K3'": 0, "K4": 0,
            "K5": 0, "K1 vec": 12, "K2 tc": 12}
    ms, per_call = [], None

    def counts():
        # K2's tensor-core launches beside the rest
        return dict(launch_counts(counters),
                    **{"K2 tc": counters["K2"].tc_launches})

    for i in range(GRAFT_CALLS):
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(params, img, hw)
        end.record()
        torch.cuda.synchronize()
        now = counts()
        got = {k: now[k] - before[k] for k in want}
        if got != want:
            fail(f"entry() call {i}: launches {got} != {want}")
        if not all(torch.isfinite(o).all() for o in out):
            fail(f"entry() call {i}: non-finite outputs")
        ms.append(start.elapsed_time(end))
        per_call = got
    res = dict(entry_ms=float(np.median(ms)), entry_launches=per_call)
    log(f"  entry(): outputs {[tuple(o.shape) for o in out]}, launches a "
        f"call {per_call}; median {res['entry_ms']:.2f} ms over "
        f"{GRAFT_CALLS} calls (CUDA events, {GRAFT_WARMUP} untimed first) "
        f"[{smi}]")
    del fn, params, out
    # float32 on the card against the CPU
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    tap = _EncoderTap()
    try:
        with tempfile.TemporaryDirectory(prefix="graft_f32_") as td:
            path = os.path.join(td, "paper_f32.py")
            with open(path, "w") as f:
                f.write(f"_base_ = {graft_entry.FLAGSHIP_CFG!r}\n"
                        "model = dict(compute_dtype='float32')\n")
            x = torch.from_numpy(np.random.default_rng(8).normal(
                size=(1, 256, 256, 3)).astype(np.float32))
            outs, mem = {}, {}
            for dev in ("cuda", "cpu"):
                fn, (params, _, hw) = graft_entry.entry(device=dev,
                                                        config=path)
                outs[dev] = [o.float().cpu() for o in fn(params, x.to(dev),
                                                         hw)]
                mem[dev] = tap.out.float().cpu()
                del fn, params
    finally:
        tap.handle.remove()
        torch.backends.cudnn.allow_tf32 = prev

    def err(a, b):
        return ((a - b).abs() - GRAFT_TOL * b.abs()).max().item()

    m_err = (mem["cuda"] - mem["cpu"]).abs().max().item()
    if err(mem["cuda"], mem["cpu"]) > GRAFT_TOL:
        fail(f"entry() f32 card vs CPU: encoder memory max abs error "
             f"{m_err:.3e}")
    same_pick = err(outs["cuda"][3], outs["cpu"][3]) <= GRAFT_TOL
    o_err = [(a - b).abs().max().item()
             for a, b in zip(outs["cuda"], outs["cpu"])]
    # order-free: the picked proposals' best class scores, sorted (near-tied
    # random-init scores may trade places at or inside the cut)
    picked = [o[2].max(-1).values.sort(-1, descending=True).values
              for o in (outs["cuda"], outs["cpu"])]
    s_err = (picked[0] - picked[1]).abs().max().item()
    if err(*picked) > GRAFT_TOL:
        fail(f"entry() f32 card vs CPU: sorted top-k scores max abs error "
             f"{s_err:.3e}")
    if same_pick:
        for name, a, b in zip(("all_cls", "all_coords", "topk_score",
                               "topk_anchor"), outs["cuda"], outs["cpu"]):
            if err(a, b) > GRAFT_TOL:
                fail(f"entry() f32 card vs CPU: {name} max abs error "
                     f"{(a - b).abs().max().item():.3e}")
    log(f"  entry() float32, card vs CPU (TF32 off): encoder memory max abs "
        f"error {m_err:.2e}; the picked proposals' scores, sorted, "
        f"{s_err:.2e}; "
        + ("the top-k picks the same proposals; outputs max abs error "
           + ", ".join(f"{e:.2e}" for e in o_err) if same_pick else
           "the top-k's random-init scores pick other proposals at the cut: "
           "outputs not compared")
        + f" (tol {GRAFT_TOL:g} + {GRAFT_TOL:g}*|ref|)")
    res.update(f32_memory_err=m_err, f32_same_pick=same_pick,
               f32_output_err=o_err, f32_sorted_score_err=s_err)
    res.update(dryrun)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  graft phase {res['phase_s']:.1f} s; dryrun_multichip("
        f"{GRAFT_RANKS}) {dryrun['dryrun_s']:.1f} s beside the overfit "
        "proof and the devaug --deterministic runs, four ranks sharing one "
        f"card over gloo (no scaling figure) [{smi}]")
    return res


def start_dryrun():
    """``python -m rscotr_tpu_torch.graft_entry 4`` (the driver entry's dry
    run, four ranks sharing the card over gloo) in a session of its own,
    so that it runs beside the overfit proof and the devaug
    ``--deterministic`` runs, none of which prints a timing it would move
    but the proof's seconds; ``finish_dryrun`` waits for it."""
    import tempfile
    work = tempfile.mkdtemp(prefix="rscotr_dryrun_")
    run = dict(work=work, t0=time.time())
    run["logf"] = open(os.path.join(work, "dryrun.log"), "w")
    log(f"graft dry run: python -m rscotr_tpu_torch.graft_entry "
        f"{GRAFT_RANKS} in a process of its own, beside the overfit proof")
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "rscotr_tpu_torch.graft_entry",
         str(GRAFT_RANKS)], cwd=ROOT, stdout=run["logf"],
        stderr=subprocess.STDOUT, start_new_session=True)
    return run


def stop_dryrun(run) -> None:
    """End the dry run's session (the CLI and its ranks) if it still runs,
    and remove its files."""
    import shutil
    import signal
    if run["proc"].poll() is None:
        os.killpg(run["proc"].pid, signal.SIGKILL)
        run["proc"].wait()
    run["logf"].close()
    shutil.rmtree(run["work"], ignore_errors=True)


def finish_dryrun(run, timeout=GRAFT_TIMEOUT) -> dict:
    """Wait for the dry run and hold it: exit 0, every leg's line (the
    data-parallel steps, the grouped cls steps, the three device-augment
    steps, the eval, FSDP's step and checkpoint, the 2 x 2 mesh, the
    trajectory) over gloo on the card, ``dryrun_multichip(4) OK`` last."""
    try:
        rc = run["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"dryrun_multichip({GRAFT_RANKS}): still running after "
             f"{timeout} s of waiting")
    run["logf"].flush()
    # its own seconds: to its log's last write (it ends while the overfit
    # proof is waited for)
    secs = os.path.getmtime(run["logf"].name) - run["t0"]
    with open(run["logf"].name) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("dryrun_multichip", "FSDP over", "TP over"))]
    legs = ("] cls: loss=", "] det: loss=", "] seg: loss=",
            "cls group K=2: loss=", "cls devaug: loss=", "det devaug: loss=",
            "seg devaug: loss=", "] eval: ", "fsdp] det: loss=",
            "fsdp] checkpoint gather/save/restore", "dp*tp] cls: loss=",
            "trajectory == 1 process")
    missing = [leg for leg in legs if not any(leg in ln for ln in lines)]
    if rc != 0 or missing or not lines or "over gloo" not in lines[0] or \
            lines[-1] != f"dryrun_multichip({GRAFT_RANKS}) OK":
        fail(f"dryrun_multichip({GRAFT_RANKS}): exit {rc}, missing "
             f"{missing}:\n{text[-3000:]}")
    log(f"graft dry run: python -m rscotr_tpu_torch.graft_entry "
        f"{GRAFT_RANKS}, exit 0, {secs:.1f} s from its start to its last "
        "line")
    for ln in lines:
        log(f"  {ln}")
    return dict(dryrun_s=secs, dryrun_lines=lines)


def bench_phase(smi):
    """``python -m rscotr_tpu_torch.bench`` in a process of its own, as the
    driver would run a harness (``RSCOTR_BENCH_TRAIN_ITERS`` at its
    default): one line on stdout with the root harness's keys, no
    ``train_bench_error``, 0 < mfu <= 1; the K1 / K2 launches per inference
    call (its stderr) the serving phase's (``EVAL_WANT``)."""
    log("bench phase: python -m rscotr_tpu_torch.bench (the flagship devaug "
        "co-training headline, then the root's inference fields)")
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k != "RSCOTR_BENCH_TRAIN_ITERS"}
    p = subprocess.run([sys.executable, "-m", "rscotr_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    for line in p.stderr.splitlines():
        if line.startswith("bench: "):
            log(f"  {line}")
    lines = p.stdout.strip().splitlines()
    if p.returncode or len(lines) != 1:
        print(p.stdout[-4000:], file=sys.stderr)
        print(p.stderr[-8000:], file=sys.stderr)
        fail(f"bench: exit {p.returncode}, {len(lines)} stdout lines")
    out = json.loads(lines[0])
    if "train_bench_error" in out or set(out) != BENCH_LINE_KEYS:
        fail(f"bench: keys {sorted(out)}, want {sorted(BENCH_LINE_KEYS)}; "
             f"train_bench_error {out.get('train_bench_error')}")
    if out["mfu"] is None or not 0 < out["mfu"] <= 1:
        fail(f"bench: mfu {out['mfu']}")
    m = re.search(r"launches per inference call (\{.*\})", p.stderr)
    if m is None:
        fail("bench: no launches line on stderr")
    per_call = json.loads(m.group(1))
    for task, (k1, k2) in EVAL_WANT.items():
        if (per_call[task]["K1"], per_call[task]["K2"]) != (k1, k2):
            fail(f"bench {task}: K1 / K2 launches per call "
                 f"{per_call[task]}, want {k1} / {k2}")
    log(f"  bench line: {json.dumps(out)}")
    log(f"  bench: headline {out['value']} img/s, train_s_per_iter "
        f"{out['train_s_per_iter']} s (the devaug co-training mix), "
        f"inference {out['infer_img_s']} img/s (device ms cls "
        f"{out['cls_ms']}, det {out['det_ms']}, seg {out['seg_ms']}; "
        f"dispatch ms {out['cls_dispatch_ms']} / {out['det_dispatch_ms']} / "
        f"{out['seg_dispatch_ms']}), {out['unit_gflops']} GFLOP a mix, mfu "
        f"{out['mfu']}; K1 / K2 per inference call " + ", ".join(
            f"{t} {per_call[t]['K1']:g} / {per_call[t]['K2']:g}"
            for t in EVAL_WANT) + f"; {wall:.1f} s  [{smi}]")
    return dict(out, phase_s=wall)


# -- the tools phase -------------------------------------------------------

# K1 / K1b / K2 / K2b launches per call of the flagship's requests and
# train steps (the serving, training and eval phases' counts): the cls
# head reads no encoder; det runs 6 encoder and 6 decoder MSDA layers, seg
# the pixel decoder's 6; 12 Swin blocks per backbone pass
TOOL_WANT = {
    ("infer", "cls"): (0, 0, 12, 0), ("infer", "det"): (12, 0, 12, 0),
    ("infer", "seg"): (6, 0, 12, 0), ("train", "cls"): (0, 0, 12, 12),
    ("train", "det"): (12, 12, 12, 12), ("train", "seg"): (6, 6, 12, 12)}
# with_cp: the recompute runs each encoder layer and Swin block again
CP_WANT = {("train", "det"): (18, 12, 24, 12)}
BENCH_KEYS = {"infer_ms", "infer_gflops", "infer_temp_mb", "infer_mfu",
              "train_ms", "train_gflops", "train_temp_mb", "train_mfu"}
EVAL_LOOP_KEYS = {"task", "images", "img_per_s", "total_s",
                  "host_pipeline_s", "host_share", "metric_s"}
FEATMAP_SIZES = (224, 800, 512)
FEATMAP_PNGS = 2
# the parity dump's input seeds tried (the first that clears the margins)
DUMP_SEEDS = 16
K4 = ("K1", "K1b", "K2", "K2b")


def kernel_flops_recorder():
    """Patches the four kernels' CUDA entry points (which the operators'
    CUDA bodies call) to add each launch's operation count, from
    ``ops/flops.py``'s formulas at the launch's shapes, while ``on``."""
    from rscotr_tpu_torch.ops import flops
    from rscotr_tpu_torch.ops import ms_deform_attn as msda
    from rscotr_tpu_torch.ops import window_attention as wa
    rec = {"on": False, "flops": dict.fromkeys(
        ("msda_fwd", "msda_bwd", "window_attn_fwd", "window_attn_bwd"), 0)}

    def wrap(mod, attr, op, count):
        real = getattr(mod, attr)

        def call(*a, **kw):
            if rec["on"]:
                rec["flops"][op] += count(*a)
            return real(*a, **kw)
        setattr(mod, attr, call)
        return mod, attr, real

    def tiles(q, *_):
        B, nW, H, n, hd = q.shape
        return B * nW * H, n, hd

    rec["restore"] = [
        wrap(msda, "_ms_deform_attn_cuda", "msda_fwd",
             lambda v, s, loc, *_: flops.msda_fwd_flops(
                 flops.msda_corners(loc.shape), v.shape[-1])),
        wrap(msda, "_msda_bwd_cuda", "msda_bwd",
             lambda v, s, loc, *_: flops.msda_bwd_flops(
                 flops.msda_corners(loc.shape), v.shape[-1])),
        wrap(wa, "_window_attention_cuda", "window_attn_fwd",
             lambda *a: flops.window_attn_flops(*tiles(*a))),
        wrap(wa, "_window_attention_bwd_cuda", "window_attn_bwd",
             lambda *a: flops.window_attn_bwd_flops(*tiles(*a)))]
    return rec


def run_benchmark(name, argv, counters, want, n_calls, smi):
    """``tools/benchmark.main(argv)`` with every count set to 0 just before
    and read just after; each ``count_flops`` call (one request or step,
    outside the timed window) checked: its K1 / K1b / K2 / K2b launches
    against ``want`` and ``FlopCounterMode``'s count of each kernel
    operator against the formulas summed over the launches; the run's
    launches against ``n_calls`` calls of each. Returns (report, the run's
    launches)."""
    from rscotr_tpu_torch.tools import benchmark
    rec = kernel_flops_recorder()
    calls = []
    real = benchmark.count_flops

    def counted(fn):
        before = launch_counts(counters)
        rec["flops"] = dict.fromkeys(rec["flops"], 0)
        rec["on"] = True
        try:
            out = real(fn)
        finally:
            rec["on"] = False
        after = launch_counts(counters)
        calls.append(({k: after[k] - before[k] for k in after},
                      dict(rec["flops"]), out[2]))
        return out

    benchmark.count_flops = counted
    try:
        log(f"  rscotr_tpu_torch.tools.benchmark {' '.join(argv)}")
        zero_counts(counters)
        t0 = time.perf_counter()
        report = benchmark.main(argv)
        wall = time.perf_counter() - t0
        total = launch_counts(counters)
    finally:
        benchmark.count_flops = real
        for mod, attr, fn in rec["restore"]:
            setattr(mod, attr, fn)
    if "eval_loop" in report:
        for ds, ev in report["eval_loop"].items():
            if set(ev) != EVAL_LOOP_KEYS:
                fail(f"benchmark {name}: eval_loop {ds} keys {sorted(ev)}")
        log(f"  benchmark {name}: {json.dumps(report['eval_loop'])} "
            f"({wall:.1f} s)  [{smi}]")
        return report, total
    tasks = list(report["tasks"])
    phases = [p for p in ("infer", "train")
              if f"{p}_ms" in report["tasks"][tasks[0]]]
    keys = [(p, t) for p in phases for t in tasks]
    if len(calls) != len(keys):
        fail(f"benchmark {name}: {len(calls)} FLOP-count calls for {keys}")
    for (phase, task), (got, formula, counted_ops) in zip(keys, calls):
        entry = report["tasks"][task]
        missing = {k for k in BENCH_KEYS if k.startswith(phase)} - set(entry)
        if missing:
            fail(f"benchmark {name} {task}: keys {sorted(missing)} missing")
        mfu = entry[f"{phase}_mfu"]
        if not 0 < mfu <= 1:
            fail(f"benchmark {name} {task} {phase}_mfu {mfu}")
        w = dict(zip(K4, want[(phase, task)]))
        if any(got[k] != w[k] for k in K4) or \
                got["K1 vec"] != w["K1"] or got["K1b vec"] != w["K1b"] or \
                any(got[k] for k in QUAD):
            fail(f"benchmark {name} {phase} {task}: launches {got} != {w}, "
                 "every K1 / K1b on the vector body, no quad-path kernel")
        if counted_ops != formula or counted_ops != entry[
                f"{phase}_kernel_flops"]:
            fail(f"benchmark {name} {phase} {task}: FlopCounterMode's "
                 f"operator counts {counted_ops} != the formulas over the "
                 f"launches {formula}")
        log(f"  benchmark {name} {phase} {task}: {entry[phase + '_ms']:.3f}"
            f" ms, {entry[phase + '_gflops']:.2f} GFLOP "
            f"(kernel operators {sum(formula.values()) / 1e9:.3f} = the "
            f"formulas over the launches), MFU {mfu:.4f}, temp "
            f"{entry[phase + '_temp_mb']:.1f} MiB; launches per call "
            + ", ".join(f"{k} {got[k]}" for k in K4) + f"  [{smi}]")
    run_want = {k: n_calls * sum(want[key][i] for key in keys)
                for i, k in enumerate(K4)}
    if any(total[k] != run_want[k] for k in K4):
        fail(f"benchmark {name}: launches in the run {total} != {run_want} "
             f"({n_calls} calls of each request and step)")
    log(f"  benchmark {name}: {wall:.1f} s, launches in the run "
        + ", ".join(f"{k} {total[k]}" for k in K4))
    return report, total


OVERFIT_ARGV = ["--eval-every", "250", "--max-iters", "4000"]


def overfit_proof_process(argv) -> int:
    """``chip_smoke.py --overfit-proof OUT WORK_DIR``: the overfit proof
    (``tools/overfit_proof.py`` through its ``main``, ``OVERFIT_ARGV``) in a
    process of its own, every count at 0 just before it; its result, the
    launches, the seconds and its markdown log written to OUT as JSON."""
    from rscotr_tpu_torch.tools import overfit_proof
    out, work = argv
    counters = kernel_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    proof = overfit_proof.main(["--work-dir", work, *OVERFIT_ARGV,
                                "--device", "cuda"])
    rec = dict(proof=proof, launches=launch_counts(counters),
               seconds=time.perf_counter() - t0)
    with open(os.path.join(work, "proof.md")) as f:
        rec["log"] = f.read()
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def start_overfit_proof():
    """Start the overfit proof in a process of its own (it is host-bound:
    tiny steps, ~60-130 ms an iteration on the card's host), so that it runs
    beside the scale-out phase's untimed runs and checks and the devaug
    ``--deterministic`` runs; ``finish_overfit_proof`` waits for it."""
    import tempfile
    work = tempfile.mkdtemp(prefix="rscotr_overfit_")
    run = dict(work=work, out=os.path.join(work, "proof.json"),
               t0=time.perf_counter())
    run["logf"] = open(os.path.join(work, "proof.log"), "w")
    cmd = [sys.executable, os.path.abspath(__file__), "--overfit-proof",
           run["out"], os.path.join(work, "overfit")]
    log(f"overfit proof: rscotr_tpu_torch.tools.overfit_proof "
        f"{' '.join(OVERFIT_ARGV)} in a process of its own (chip_smoke.py "
        "--overfit-proof), beside the scale-out phase's untimed rest and "
        "the devaug --deterministic runs")
    run["proc"] = subprocess.Popen(cmd, cwd=ROOT, stdout=run["logf"],
                                   stderr=subprocess.STDOUT)
    return run


def stop_overfit_proof(run) -> None:
    """End the proof's process if it still runs, and remove its files."""
    import shutil
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()
    run["logf"].close()
    shutil.rmtree(run["work"], ignore_errors=True)


def finish_overfit_proof(run, smi, timeout=900):
    """Wait for the proof's process and hold its result: every target met
    (cls top-1 100, det mAP_50 >= 0.9, seg mIoU >= 90) within 4000
    iterations, K1 / K1b / K2 / K2b launched, no quad-path kernel. Returns
    its launches and its result."""
    t0 = time.perf_counter()
    try:
        rc = run["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"overfit proof: still running after {timeout} s of waiting")
    run["logf"].flush()
    if rc:
        with open(os.path.join(run["work"], "proof.log")) as f:
            print(f.read()[-8000:], file=sys.stderr)
        fail(f"overfit proof: its process exited {rc}")
    with open(run["out"]) as f:
        rec = json.load(f)
    proof, total, secs = rec["proof"], rec["launches"], rec["seconds"]
    log("  " + "\n  ".join(rec["log"].splitlines()))
    log(f"  overfit proof: first met {proof['first_met']}, final "
        f"{proof['final']}, {secs:.1f} s in its process (waited "
        f"{time.perf_counter() - t0:.1f} s after the devaug runs); "
        "launches " + ", ".join(f"{k} {total[k]}" for k in K4)
        + f" (K1 vector body {total['K1 vec']}, K1b {total['K1b vec']})  "
        f"[{smi}]")
    if not proof["ok"]:
        fail(f"overfit proof: targets not met within 4000 iterations: "
             f"{proof}")
    # the tiny model's decoder heads are narrower than the vector body's
    # widths: part of K1 / K1b takes the lane body there
    if any(total[k] == 0 for k in K4) or any(total[k] for k in QUAD):
        fail(f"overfit proof: launches {total}")
    return {k: total[k] for k in K4}, dict(proof, seconds=secs)


def tools_phase(smi, kept):
    """The port's user tools on the card (``rscotr_tpu_torch/tools``), each
    through its ``main`` with every count set to 0 just before it and read
    just after: (1) the benchmark on the flagship at full width and depth
    (``--tasks cls det seg --train --iters 10 --warmup 2``; again with
    ``with_cp`` on the backbone and the shared encoder, det only; then
    ``--eval-loop --iters 2``), its reports' keys, ``0 < MFU <= 1``, per
    call the launches (``TOOL_WANT``, ``CP_WANT``) and FlopCounterMode's
    operator counts equal to the formulas over the launches, the with_cp
    det step's ``train_temp_mb`` below the plain one; (2) the overfit proof
    runs in a process of its own beside the scale-out phase's untimed rest
    (``start_overfit_proof``); (3) the
    parity dump of the tiny config's seeded init on the card and on the
    CPU (float32, TF32 off), then ``compare``: cls and seg within
    SLICE_TOL, det boxes within SLICE_TOL x the image size, labels equal,
    on inputs of the first seed whose det top-k cut gap and seg
    attention-mask margin clear 10 x SLICE_TOL on the CPU; (4) ``featmap_vis.vis_featmap_single_img`` at 224^2, 800^2
    and 512^2 on seeded PNGs with the eval phase's flagship ``.pth``: the
    root tools' file names, K2 once per Swin block per image, and the
    backbone's maps on the card against the CPU's within SLICE_TOL
    (relative above 1; float32, TF32 off); (5) the confusion matrix of the
    eval phase's cls scores, its accuracy equal to the eval phase's. The
    eval phase's work dir is removed at the end."""
    import contextlib
    import importlib.util
    import io
    import shutil

    from PIL import Image

    from rscotr_tpu_torch.apis import derive_shapes
    from rscotr_tpu_torch.data.build import load_data_cfg
    from rscotr_tpu_torch.engine import make_infer_steps, save_checkpoint
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.tools import parity_check
    from rscotr_tpu_torch.tools.confusion_matrix import (
        get_cls_confusion_matrix)
    from rscotr_tpu_torch.tools.featmap_vis import (_common,
                                                    vis_featmap_single_img)
    from rscotr_tpu_torch.utils.config import load_cfg
    counters = kernel_counters()
    t_phase = time.perf_counter()
    work = kept["work_dir"]
    res, paths = {"seconds": {}}, {}
    log("tools phase: the port's benchmark, parity dump, featmap and "
        "confusion-matrix tools on the card")
    try:
        # -- 1. benchmark ------------------------------------------------
        t0 = time.perf_counter()
        iters, warm = 10, 2
        base = ["--iters", str(iters), "--warmup", str(warm)]
        plain, total = run_benchmark(
            "flagship", [FLAGSHIP_CFG, "--tasks", "cls", "det", "seg",
                         "--train"] + base, counters, TOOL_WANT,
            iters + warm + 2, smi)
        paths["benchmark (cls, det, seg requests and steps, 14 calls "
              "each)"] = total
        cp, total = run_benchmark(
            "flagship with_cp", [FLAGSHIP_CFG, "--tasks", "det", "--train",
                                 "--cfg-options",
                                 "model.backbone.with_cp=True",
                                 "model.shared_encoder.with_cp=True"]
            + base, counters, {**TOOL_WANT, **CP_WANT},
            iters + warm + 2, smi)
        paths["benchmark with_cp (det request and step, 14 calls "
              "each)"] = total
        a = plain["tasks"]["det"]["train_temp_mb"]
        b = cp["tasks"]["det"]["train_temp_mb"]
        log(f"  with_cp: det step temp {b:.1f} MiB against {a:.1f} MiB "
            f"without ({100 * (1 - b / a):.1f}% less), step "
            f"{cp['tasks']['det']['train_ms']:.2f} ms against "
            f"{plain['tasks']['det']['train_ms']:.2f} ms  [{smi}]")
        if not b < a:
            fail(f"with_cp: det train_temp_mb {b} is not below {a}")
        ev, total = run_benchmark(
            "flagship eval-loop", [FLAGSHIP_CFG, "--eval-loop", "--iters",
                                   "2"], counters, {}, 0, smi)
        paths["benchmark --eval-loop (2 + 1 batches a val set)"] = total
        res["benchmark"] = dict(plain=plain["tasks"],
                                with_cp=cp["tasks"]["det"],
                                eval_loop=ev["eval_loop"])
        res["seconds"]["benchmark"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

        # -- 3. parity dump ----------------------------------------------
        t0 = time.perf_counter()
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tiny = load_data_cfg(load_cfg(TINY_CFG), config_root=ROOT,
                             filename=TINY_CFG)
        model = build_model(tiny["model"], device="cpu",
                            generator=torch.Generator().manual_seed(0))
        pth = save_checkpoint(os.path.join(work, "tiny"), 0, model)
        k = tiny["model"]["test_cfg"]["det"]["max_per_img"]
        # the dump's input seed: the first whose det top-k cut gap and
        # smallest seg attention-mask logit (on the CPU, the reference;
        # inputs drawn as the tool draws them) both clear 10 x SLICE_TOL,
        # so that no kept detection or mask bit is a coin toss
        shapes = derive_shapes(tiny)
        det_hw = max(shapes["det"][1:3])
        more_steps = make_infer_steps(model, max_per_img=k + 1)
        for seed in range(DUMP_SEEDS):
            rng = np.random.default_rng(seed)
            rng.normal(size=(1,) + shapes["cls"][1:])
            det_x = rng.normal(size=(1,) + shapes["det"][1:]).astype(
                np.float32)
            seg_x = rng.normal(size=(1,) + shapes["seg"][1:]).astype(
                np.float32)
            more, _ = more_steps["det"](
                det_x, np.array([shapes["det"][1:3]], np.int32),
                np.ones((1, 4), np.float32))
            gap = float(more[0, k - 1, 4] - more[0, k, 4])
            margin = seg_mask_margin(model, (seg_x,),
                                     tiny["model"]["test_cfg"]["seg"])
            log(f"  parity dump inputs, seed {seed}: det top-{k} cut gap "
                f"{gap:.3e}, smallest seg attention-mask logit "
                f"{margin:.3e} (each must exceed 10 x {SLICE_TOL:g})")
            if gap > 10 * SLICE_TOL and margin > 10 * SLICE_TOL:
                break
        else:
            fail(f"parity dump: no seed below {DUMP_SEEDS} clears the det "
                 "cut and the seg mask margins")
        dumps = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"dump_{dev}.npz")
            argv = ["dump", TINY_CFG, pth, "--out", out, "--seed",
                    str(seed), "--device", dev]
            log(f"  rscotr_tpu_torch.tools.parity_check {' '.join(argv)}")
            zero_counts(counters)
            if parity_check.main(argv) != 0:
                fail(f"parity dump on {dev} failed")
            if dev == "cuda":
                paths["parity dump (tiny cls, det, seg)"] = launch_counts(
                    counters)
            dumps[dev] = dict(np.load(out))
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        got, want = dumps["cuda"], dumps["cpu"]
        if sorted(got) != ["cls", "det_boxes", "det_labels", "seg"] or \
                sorted(want) != sorted(got):
            fail(f"parity dump keys {sorted(got)} / {sorted(want)}")
        box_tol = SLICE_TOL * det_hw
        errs = {}
        for key, tol in (("cls", SLICE_TOL), ("det_scores", SLICE_TOL),
                         ("det_boxes", box_tol), ("seg", SLICE_TOL)):
            a, b = ((got["det_boxes"][..., 4], want["det_boxes"][..., 4])
                    if key == "det_scores" else
                    (got[key][..., :4], want[key][..., :4])
                    if key == "det_boxes" else (got[key], want[key]))
            errs[key] = float(np.abs(a.astype(np.float64) - b).max())
            log(f"  dump {key} {a.shape}: card vs CPU max_abs_err "
                f"{errs[key]:.3e} (tol {tol:g})")
            if not errs[key] <= tol:
                fail(f"parity dump: {key} differs between card and CPU")
        if not np.array_equal(got["det_labels"], want["det_labels"]):
            fail("parity dump: det labels differ between card and CPU")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = parity_check.main(["compare", os.path.join(
                work, "dump_cuda.npz"), os.path.join(work, "dump_cpu.npz"),
                "--tol", str(box_tol)])
        log("  " + "\n  ".join(out.getvalue().splitlines()))
        if rc != 0:
            fail("parity_check compare: FORWARD PARITY FAIL")
        res["parity"] = errs
        res["seconds"]["parity dump"] = time.perf_counter() - t0

        # -- 4. featmap --------------------------------------------------
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        pngs = []
        for i in range(FEATMAP_PNGS):
            p = os.path.join(work, f"featmap_{i}.png")
            Image.fromarray(rng.integers(0, 256, (300 + 40 * i, 400, 3))
                            .astype(np.uint8)).save(p)
            pngs.append(p)
        zero_counts(counters)
        written = []
        for size in FEATMAP_SIZES:
            for p in pngs:
                written += vis_featmap_single_img.main([
                    FLAGSHIP_CFG, p, "--checkpoint", kept["pth"],
                    "--size", str(size), "--out-dir",
                    os.path.join(work, f"featmap_{size}"), "--device",
                    "cuda"])
        total = launch_counts(counters)
        n_img = len(FEATMAP_SIZES) * len(pngs)
        if total["K2"] != 12 * n_img or any(
                total[k] for k in counters if k != "K2"):
            fail(f"featmap: launches {total} != K2 12 per image x {n_img}")
        paths[f"featmap single image ({n_img} images at 224^2, 800^2, "
              "512^2)"] = total
        names = sorted({os.path.basename(w) for w in written})
        want_names = sorted(f"featmap_{i}_l{lvl}_top20.png"
                            for i in range(len(pngs)) for lvl in range(4))
        if names != want_names or not all(os.path.getsize(w) for w in
                                          written):
            fail(f"featmap: wrote {names}, not {want_names}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        nets = {d: _common.load_backbone(FLAGSHIP_CFG, kept["pth"],
                                         device=d) for d in ("cuda", "cpu")}
        worst = {}
        img = np.asarray(Image.open(pngs[0]).convert("RGB"))
        for size in FEATMAP_SIZES:
            x = _common.preprocess(img, size)
            a, b = (_common.run_backbone(nets[d], x) for d in ("cuda",
                                                              "cpu"))
            worst[size] = max(float((np.abs(u - v) / np.maximum(
                1.0, np.abs(v))).max()) for u, v in zip(a, b))
            log(f"  featmap {size}^2: {len(a)} maps "
                f"{[tuple(u.shape) for u in a]}, card vs CPU max err "
                f"{worst[size]:.2e} (tol {SLICE_TOL:g}, relative above 1)")
            if not worst[size] <= SLICE_TOL:
                fail(f"featmap {size}^2: card and CPU maps differ")
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        del nets
        log(f"  featmap: {len(written)} montages under the root tools' "
            f"names ({', '.join(names[:2])}, ...), K2 {total['K2']} "
            f"launches = 12 per image x {n_img}")
        res["featmap"] = worst
        res["seconds"]["featmap"] = time.perf_counter() - t0

        # -- 5. confusion matrix -----------------------------------------
        t0 = time.perf_counter()
        gt = os.path.join(work, "cls_gt.npy")
        pred = os.path.join(work, "cls_pred.npy")
        np.save(gt, kept["cls_labels"])
        np.save(pred, kept["cls_scores"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cm = get_cls_confusion_matrix.main([
                gt, pred, "--out", os.path.join(work, "cm.npy"), "--plot",
                os.path.join(work, "cm.png")])
        log("  " + "\n  ".join(out.getvalue().splitlines()))
        acc = float(np.trace(cm) / cm.sum())
        want_acc = kept["accuracy"] / 100
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        log(f"  confusion matrix {cm.shape}: accuracy {acc:.6f}, the eval "
            f"phase's resisc.accuracy_top-1 / 100 {want_acc:.6f}; plot "
            f"{'written' if has_mpl else 'skipped (no matplotlib)'}")
        if abs(acc - want_acc) > 1e-9 or cm.sum() != len(kept["cls_labels"]):
            fail("confusion matrix: accuracy differs from the eval phase's")
        if ("skipped plot" in out.getvalue()) == has_mpl:
            fail("confusion matrix: the plot's skip line is wrong")
        res["confusion"] = dict(accuracy=acc, plot=has_mpl)
        res["seconds"]["confusion matrix"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  tools phase {res['phase_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in res["seconds"].items())
        + f")  [{smi}]")
    return {k: {kk: v[kk] for kk in K4} for k, v in paths.items()}, res


def dropout_fields(r):
    """K2's and K2b's DROP bodies at the timed stage: their time, the p = 0
    bodies' on the same tensors in the same turns, the rate."""
    return dict(dropout_ms=r["dropout_ms"], dropout_p0_ms=r["dropout_p0_ms"],
                dropout_p=r["dropout_p"])


def kernels_line(times, btimes, qtimes, err, berr, qerr, k6err, k6levels,
                 launches, k7):
    """The ``{"kernels": [...]}`` object: nine kernels, each with its
    launches on the main path, its error against the plain version, its
    time beside the plain version's, its bound and its library yardstick."""
    det_enc = "det encoder B=1 Q=Nv=13294 H=8 L=4 P=4 D=32 bf16"
    # K1b's time depends on how many corners lie on the map: the headline is
    # the case with a model's locations, [0, 1]
    k1b = btimes["K1b det-encoder B=1 loc in [0, 1]"]
    k3 = btimes["K3' det-encoder B=1 loc in [0, 1]"]
    ws_at = "det encoder g (8, 13294, 16, 128) bf16, wt (8, 13294, 64) bf16"
    det_s0 = "det 800^2 stage 0 B=1 nW=841 H=3 n=49 hd=32 shifted bf16"
    sdpa = ("F.scaled_dot_product_attention(q, k, v, attn_mask=bias + mask, "
            "scale=scale)")
    # K6's inputs are made inside the probe, which reports what it timed:
    # the bytes of table, idx, w and the output, one multiply per output
    k6 = k6levels[10000]
    k6_bound, k6_by = bound(k6["bytes"], float(k6["out_elements"]), "f32")

    def entry(name, source, replaces, key, r, errs, timed_at, library=None,
              **more):
        return dict(
            name=name, route="cuda", source=f"rscotr_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches[key], max_abs_err=errs[0],
            max_abs_err_bf16=errs[1], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library=library, timed_at=timed_at,
            **{f: r[f] for f in ("eager_ms", "library_backend") if f in r},
            **more)

    def stages(table, kernel):
        return {name[len(kernel) + 1:]: r for name, r in table.items()
                if name.startswith(kernel + " ")}

    pallas = "rscotr_tpu/ops/pallas/"
    k1 = times[f"K1 {K1_HEADLINE}"]
    return {"kernels": [
        entry("msda_fwd", "msda_fwd.cu",
              pallas + "ms_deform_attn_kernel.py:138", "K1",
              k1, err["K1"], det_enc + ", locations in [0, 1]",
              lane_ms=k1["lane_ms"], launches_serving=launches["K1 serving"],
              launches_paths=launches["paths"]["K1"],
              vec_launches=launches["K1 vec"],
              vec_launches_serving=launches["K1 vec serving"],
              stages=stages(times, "K1")),
        entry("window_attn", "window_attn.cu",
              pallas + "window_attention.py:116", "K2",
              times["K2 det800.s0"], err["K2"], det_s0, library=sdpa,
              launches_serving=launches["K2 serving"],
              launches_paths=launches["paths"]["K2"],
              **dropout_fields(times["K2 det800.s0"]),
              stages=stages(times, "K2")),
        entry("msda_bwd", "msda_bwd.cu",
              pallas + "ms_deform_attn_kernel.py:138", "K1b",
              k1b, berr["K1b"], det_enc + ", locations in [0, 1]",
              replaces_part="backward (JAX: autodiff of _ms_deform_attn_xla,"
                            " rscotr_tpu/ops/ms_deform_attn.py:270)",
              fuses="scatter_add (K3') on the model path",
              vec_launches=launches["K1b vec"],
              launches_paths=launches["paths"]["K1b"],
              ordered_ms=k1b["ordered_ms"],
              ordered_launches_deterministic_steps=launches[
                  "K1b ordered deterministic"],
              whole_ms=k1b["whole_ms"], whole_eager_ms=k1b["whole_eager_ms"],
              stages=stages(btimes, "K1b")),
        entry("scatter_add", "scatter_add.cu", pallas + "scatter_mm.py:168",
              "K3'", k3, berr["K3"],
              "det encoder d_g (8, 212704, 128) bf16 -> (8, 13294, 128) f32, "
              "the plain backward's quad-row updates at locations in [0, 1]; "
              "ms: the launch alone into a zeroed accumulator",
              library="Tensor.index_add_(0, rows, f32 updates)",
              launches_at="the quad-gather MSDA (impl=\"quad\") backward",
              launches_train_run=launches["K3' training"],
              vec_launches=launches["K3' vec"], scalar_ms=k3["scalar_ms"],
              whole_ms=k3["whole_ms"], whole_eager_ms=k3["whole_eager_ms"],
              stages=stages(btimes, "K3'")),
        entry("window_attn_bwd", "window_attn_bwd.cu",
              pallas + "window_attention.py:116", "K2b",
              btimes["K2b det800.s0"], berr["K2b"], det_s0,
              library="torch.autograd.grad of " + sdpa + " for q, k, v",
              replaces_part="backward (JAX: autodiff of the einsum path, "
                            "rscotr_tpu/models/backbones/swin.py:130)",
              launches_paths=launches["paths"]["K2b"],
              ordered_ms=btimes["K2b det800.s0"]["ordered_ms"],
              ordered_launches_deterministic_steps=launches[
                  "K2b ordered deterministic"],
              **dropout_fields(btimes["K2b det800.s0"]),
              stages=stages(btimes, "K2b")),
        entry("ws_fwd", "msda_ws.cu", pallas + "msda_ws.py:110", "K4",
              qtimes["K4 det-encoder"], qerr["K4"], ws_at,
              library=qtimes["K4 det-encoder"]["library"],
              vec_launches=launches["K4 vec"],
              row_ms=qtimes["K4 det-encoder"]["row_ms"]),
        entry("ws_bwd", "msda_ws.cu", pallas + "msda_ws.py:135", "K5",
              qtimes["K5 det-encoder"], qerr["K5"], ws_at,
              vec_launches=launches["K5 vec"],
              row_ms=qtimes["K5 det-encoder"]["row_ms"]),
        entry("weighted_gather", "weighted_gather.cu",
              "tools/probe_msda_weighted_gather_mm.py:103", "K6",
              dict(ms=k6["weighted_mm"], plain_ms=k6["prod_gather"],
                   bound_ms=k6_bound, bound_by=k6_by, library_ms=None),
              k6err, "G=8 K=53376 Nv=10000 C=128 bf16",
              plain="production_level_slice (gather, then x w in f32)",
              levels=k6levels),
        entry("layer_norm_fwd", "layer_norm.cu",
              "none (flax nn.LayerNorm, fused by XLA)", "K7",
              k7[1]["K7 cls224.s0 norm1"], k7[0],
              k7[1]["K7 cls224.s0 norm1"]["timed_at"]
              + " (cls 256 x 224^2, stage 1 block norm)",
              library="F.layer_norm(x, (C,), w, b) (writes f32)",
              launches_per_request=launches["K7 per request"],
              library_eager_ms=k7[1]["K7 cls224.s0 norm1"][
                  "library_eager_ms"],
              host_us=k7[2], stages=stages(k7[1], "K7")),
    ]}


def main(argv) -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # cuBLAS takes its workspace setting when it makes a handle: set it
    # before any, for the --deterministic runs and steps below
    # (utils/rng.py's CUBLAS_WORKSPACE_CONFIG)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if argv[:1] == ["--scaleout-rank"]:
        return scaleout_rank(argv[1:])
    if argv[:1] == ["--overfit-proof"]:
        return overfit_proof_process(argv[1:])
    if argv[:1] == ["--soak-leg"]:
        return soak_leg(argv[1:])
    from rscotr_tpu_torch.ops import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    info = kernel_lib.build()
    log(f"build: {'compiled' if info.compiled else 'cached'} "
        f"{info.path.name} with nvcc in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    err, times = kernel_phase()
    k7err, k7times, k7host = layer_norm_phase()
    k2_long_phase()
    berr, btimes = backward_phase()
    dropout_phase(times, btimes)
    qerr, qtimes, qlaunches = quad_phase()
    k6err, k6levels, k6launches = k6_phase()
    slice_parity_phase()
    train_parity_phase()
    slaunches, lat = serving_phase()
    det_graph_phase()
    launches, train, det_cost = train_phase()
    stages = augment_phase()
    zlaunches, zoo = zoo_phase()
    elaunches, evals, det_results, kept = eval_phase(smi)
    tlaunches, tools = tools_phase(smi, kept)
    xlaunches, export = export_phase(smi, det_results)
    llaunches, loop = loop_phase(smi)
    alaunches, aug = aug_loop_phase(smi, stages)
    proof, dry = {}, {}

    def after_timed():
        proof.update(run=start_overfit_proof())
        dry.update(run=start_dryrun())

    try:
        # the proof and the driver entry's dry run start once the scale-out
        # phase's timed runs have ended, and run beside its untimed rest
        # and the devaug --deterministic runs, none of which prints a
        # timing
        scale = scaleout_phase(smi, after_timed=after_timed)
        deterministic_devaug()
        # the short soak (its drift printed, not held) in the proof's time
        klaunches, soak = soak_phase(smi)
        plaunches, tools["overfit"] = finish_overfit_proof(proof["run"], smi)
        dryrun = finish_dryrun(dry["run"])
    finally:
        if "run" in proof:
            stop_overfit_proof(proof["run"])
        if "run" in dry:
            stop_dryrun(dry["run"])
    tlaunches["overfit proof (tiny MTL, trains and evaluates; its own "
              "process)"] = plaunches
    bench = bench_phase(smi)
    graft = graft_phase(smi, dryrun)
    library_phase(times, btimes)
    # K3' is launched by the quad-gather path; the training run launches it
    # 0 times (train_phase checks every step), K1b doing its work there
    launches.update({"K1 serving": slaunches["K1"],
                     "K1 vec serving": slaunches["K1 vec"],
                     "K2 serving": slaunches["K2"], "K6": k6launches,
                     "K7": slaunches["K7"],
                     "K7 per request": slaunches["K7 per request"],
                     "K3' training": launches["K3'"]}, **qlaunches)
    # the launches of each path beside the main path, per kernel
    zlaunches.update({f"flagship {t} steps (12)": n
                      for t, n in launches.pop("per task").items()})
    zlaunches["flagship eval (cls 4, det 2, seg 2 batches)"] = elaunches
    zlaunches.update(tlaunches)
    zlaunches.update(xlaunches)
    zlaunches.update(llaunches)
    zlaunches.update(alaunches)
    zlaunches.update(klaunches)
    zlaunches["graft entry() call (paper MTL det 256^2)"] = \
        graft["entry_launches"]
    for t in ("cls", "det"):
        zlaunches[f"flagship {t} step, dropout {DROP_P}"] = \
            train["dropout"][f"{t} p={DROP_P}"]["launches"]
    launches["paths"] = {k: {path: n[k] for path, n in zlaunches.items()}
                         for k in ("K1", "K1b", "K2", "K2b")}

    log(f"summary ({smi}; {time.perf_counter() - t_start:.1f} s since the "
        f"start): " + "; ".join(
        f"serve {n} {ms:.3f} ms, peak {mb:.0f} MiB"
        for n, (ms, mb) in lat.items()) + "; " + "; ".join(
        f"train {t} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for t, r in train.items() if t != "dropout") + "; " + "; ".join(
        f"{n} {r['median_ms']:.2f} ms, peak {r['peak_mib']:.0f} MiB"
        for n, r in zoo.items()) + "; " + "; ".join(
        f"eval {n} batch {r['median_batch_ms']:.2f} ms, "
        f"{r['images_per_s']:.1f} img/s, loader "
        f"{100 * r['load_share']:.0f}%, peak {r['peak_mib']:.0f} MiB"
        for n, r in evals.items() if n in EVAL_SETS) + "; " + "; ".join(
        f"export {t} traced {export['trace_s'][t]:.2f} s, {t}.pt2 "
        f"{export['bytes'][t + '.pt2']} B, artifact request "
        + " / ".join(f"{m:.3f}" for m, _ in r["artifact"]) + " ms against "
        "live " + " / ".join(f"{m:.3f}" for m, _ in r["live"]) + " ms"
        for t, r in export["requests"].items())
        + f"; params.npz {export['bytes']['params.npz']} B; export phase "
        f"{export['phase_s']:.1f} s; " + "; ".join(
        f"loop {t} step {loop[t]['median_ms']:.2f} ms, peak "
        f"{loop[t]['peak_mib']:.0f} MiB" for t in ("cls", "det", "seg"))
        + f"; loop data wait {100 * loop['data_share']:.2f}%; " + "; ".join(
        f"{run} loop {t} step " + " / ".join(
            f"{r[t]['median_ms']:.2f}" for r in aug[run]) + " ms, peak "
        f"{aug[run][0][t]['peak_mib']:.0f} MiB"
        for run in ("devaug", "hostaug") for t in ("cls", "det", "seg"))
        + "; " + "; ".join(
        f"{run} steady data wait " + " / ".join(
            f"{100 * r['steady_share']:.2f}%" for r in aug[run])
        for run in ("devaug", "hostaug")) + "; " + "; ".join(
        f"{t} augment stage {st['ms']:.3f} ms "
        f"({100 * st['step_share']:.1f}% of its step)"
        for t, st in aug["stages"].items())
        + f"; soak preempted at iter {soak['n']}, median s/iter "
        f"mid {soak['summary']['mid']:.3f} late "
        f"{soak['summary']['late']:.3f} drift "
        f"{100 * soak['summary']['drift']:+.1f}%, soak phase "
        f"{soak['phase_s']:.1f} s; " + "; ".join(
        f"MSDA impl={i} fwd+bwd {qtimes[f'MSDA {i}'][1]:.4f} ms"
        for i in ("quad", "kernel")) + "; " + "; ".join(
        f"scale-out {k} step {v['ms']:.2f} ms, gradient sum "
        f"{v['sync_ms']:.2f} ms, peak {v['peak']:.0f} MiB"
        for k, v in scale["per_rank"].items())
        + f" (two ranks sharing the card over gloo); scale-out phase "
        f"{scale['phase_s']:.1f} s; " + "; ".join(
        f"benchmark {t} request {r['infer_ms']:.2f} ms (MFU "
        f"{r['infer_mfu']:.4f}), step {r['train_ms']:.2f} ms (MFU "
        f"{r['train_mfu']:.4f}, temp {r['train_temp_mb']:.0f} MiB)"
        for t, r in tools["benchmark"]["plain"].items())
        + f"; benchmark det step with_cp "
        f"{tools['benchmark']['with_cp']['train_ms']:.2f} ms, temp "
        f"{tools['benchmark']['with_cp']['train_temp_mb']:.0f} MiB; "
        f"overfit proof first met {tools['overfit']['first_met']} in "
        f"{tools['overfit']['seconds']:.1f} s; parity dump max errors "
        + ", ".join(f"{k} {v:.2e}" for k, v in tools["parity"].items())
        + "; featmap card vs CPU " + ", ".join(
            f"{s}^2 {v:.2e}" for s, v in tools["featmap"].items())
        + f"; confusion accuracy {tools['confusion']['accuracy']:.4f}; "
        f"tools phase {tools['phase_s']:.1f} s; " + "; ".join(
            f"train {t} step {r['on_ms'][1]:.2f} ms under --deterministic "
            f"against {r['off_ms'][1]:.2f} ms (medians)"
            for t, r in det_cost.items())
        + f"; bench {bench['value']} img/s training, "
        f"{bench['train_s_per_iter']} s/iter, inference "
        f"{bench['infer_img_s']} img/s, mfu {bench['mfu']}; bench phase "
        f"{bench['phase_s']:.1f} s; " + "; ".join(
            f"train {t} step with dropout {DROP_P} "
            f"{train['dropout'][f'{t} p={DROP_P}']['median_ms']:.2f} ms "
            f"against {train['dropout'][f'{t} p=0']['median_ms']:.2f} ms"
            for t in ("cls", "det"))
        + f"; graft entry() {graft['entry_ms']:.2f} ms a call; "
        f"dryrun_multichip({GRAFT_RANKS}) {graft['dryrun_s']:.1f} s (ranks "
        f"sharing one card, beside the overfit proof); graft phase "
        f"{graft['phase_s']:.1f} s")
    log(smi)
    print(json.dumps(kernels_line(times, btimes, qtimes, err, berr, qerr,
                                  k6err, k6levels, launches,
                                  (k7err, k7times, k7host))), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
