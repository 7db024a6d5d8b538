"""Multi-process evaluation, tensor parallelism, ROADMAP C15 and the
``--launcher pytorch`` tools of the port (2 ranks over gloo on the CPU;
tests/helpers/torch_dist.py spawns them, each with one thread and a
deadline of at most 120 s).

* ``multi_process_test`` on 2 ranks (each its strided batches, the
  results gathered) equals ``single_device_test`` result for result,
  bit for bit, on every rank.
* Tensor parallelism over 2 ranks (``parallel.tp.parallelize``: the Swin
  MLPs, the FFNs, the MSDA value / output projections, the attention q /
  k / v by heads and its output projection) gives one process's steps:
  a cls step (as JAX's ``test_tp_dp_step_matches_single_device``), and
  det, seg, cls in a row (MSDA on the local heads), each loss term and
  ``grad_norm`` within the train-slice tolerances, the parameters after
  within 2e-4 + 5e-3 * |w|; the checkpoint's gathered state (rank 0's)
  loads into a plain model.
* ROADMAP C15: with the cls batch augments on, a 2-rank step pairs images
  within each rank (mmcls's rule on each GPU): it equals one process
  applying the same draws to each rank's rows separately, and differs
  from one process pairing across the whole batch (JAX's rule).
* ``tools/train.py --launcher pytorch`` and ``tools/test.py --launcher
  pytorch`` under ``torch.distributed.run --standalone``: 3 iterations
  with the eval hook at the last on both ranks, rank 0's files; the
  2-rank evaluation of its checkpoint equals the one-process tool's
  metrics.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.torch_dist import (ROOT, TINY, run_cls_dp_step,  # noqa: E402
                                run_ranks, run_tp_steps, task_eval)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multi_process_test_equals_single_device(tmp_path, one_thread):
    ranks = run_ranks("eval", 2, tmp_path)
    want = task_eval()
    for got in ranks:
        assert list(got) == list(want)
        for name, res in want.items():
            assert len(got[name]) == len(res), name
            for g, w in zip(got[name], res):
                if isinstance(w, list):     # det: per-class arrays
                    assert len(g) == len(w)
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=name)


def _close_params(got, want):
    bad = []
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        err = (got[k] - w).abs() - (2e-4 + 5e-3 * w.abs())
        if (err > 0).any():
            bad.append(f"{k}: {float((got[k] - w).abs().max()):.3g}")
    assert not bad, bad


@pytest.mark.parametrize("tasks", [["cls"], ["det", "seg", "cls"]])
def test_tensor_parallel_steps_match_one_process(tasks, tmp_path,
                                                 one_thread):
    from helpers.torch_dist import tp_setup
    ranks = run_ranks("tp", 2, tmp_path, tasks=tasks)
    one = run_tp_steps(tasks, 1)
    for r in ranks:
        for i, (g, w) in enumerate(zip(r["logs"], one["logs"])):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-3,
                                           atol=2e-4,
                                           err_msg=f"{tasks[i]} {k}")
    assert ranks[1]["state"] == {}
    _close_params(ranks[0]["state"], one["state"])
    # the gathered state is the port's layout: a plain model loads it
    tp_setup()[1].load_state_dict(ranks[0]["state"], strict=True)


def test_c15_batch_augments_pair_within_a_rank(tmp_path, one_thread,
                                               monkeypatch):
    import rscotr_tpu_torch.engine.train_step as ts
    ranks = run_ranks("cls_dp", 2, tmp_path, augments=True)
    got_loss = sum(r["logs"]["loss"] for r in ranks)
    global_pairing = run_cls_dp_step()
    real_draw, real_aug = ts.draw_cls_augment, ts.cls_batch_augment

    def draw(g, B, H, W, *a):   # each rank's draws: its local batch
        return real_draw(g, B // 2, H, W, *a)

    def aug(img, labels, K, draws):     # applied to each rank's rows
        out, tgt = torch.empty_like(img), torch.empty(img.shape[0], K)
        for r in range(2):
            out[r::2], tgt[r::2] = real_aug(img[r::2], labels[r::2], K,
                                            draws)
        return out, tgt

    monkeypatch.setattr(ts, "draw_cls_augment", draw)
    monkeypatch.setattr(ts, "cls_batch_augment", aug)
    per_rank = run_cls_dp_step()
    np.testing.assert_allclose(got_loss, per_rank["logs"]["loss"],
                               rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["logs"]["grad_norm"],
                               per_rank["logs"]["grad_norm"], rtol=2e-5)
    _close_params(ranks[0]["state"], per_rank["state"])
    assert abs(got_loss - global_pairing["logs"]["loss"]) > 1e-3


def _torchrun(args, log, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    with open(log, "w") as f:
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2"] + args, cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT, timeout=timeout)
    if p.returncode:
        with open(log) as f:
            raise AssertionError("".join(f.readlines()[-60:]))


def test_tools_launch_under_torch_distributed_run(tmp_path, one_thread):
    from rscotr_tpu_torch.tools import test as test_cli
    wd = tmp_path / "wd"
    _torchrun(["-m", "rscotr_tpu_torch.tools.train", TINY, "--launcher",
               "pytorch", "--device", "cpu", "--max-iters", "3",
               "--work-dir", str(wd), "--cfg-options", "log_config.interval=1",
               "evaluation.interval=3"], tmp_path / "train.log")
    files = set(os.listdir(wd))
    assert {"iter_3.pth", "last_checkpoint", "metrics.jsonl",
            "best_checkpoint.pth", "train.log"} <= files
    with open(wd / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert any(k.startswith("val/dior.") for k in rows[-1])
    with open(wd / "train.log") as f:
        log = f.read()
    assert "data parallel over 2 process(es)" in log
    assert "(process 0/2)" in log

    out = tmp_path / "m2.json"
    _torchrun(["-m", "rscotr_tpu_torch.tools.test", TINY,
               str(wd / "iter_3.pth"), "--launcher", "pytorch", "--device",
               "cpu", "--eval-out", str(out)], tmp_path / "test.log")
    with open(out) as f:
        two = json.load(f)
    one = test_cli.main([TINY, str(wd / "iter_3.pth"), "--device", "cpu",
                         "--eval-out", str(tmp_path / "m1.json")])
    assert two == one
