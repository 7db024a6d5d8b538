"""Data-parallel and FSDP co-training of the port over ``torch.distributed``
(2 ranks over gloo on the CPU) against JAX's ``train_model(num_devices=2)``
and against the port's one process on the global batch.

* JAX trains the tiny config 4 iterations (cls, det, seg, cls) on a
  2-device mesh (global batch ``samples_per_gpu`` x 2, one process); the
  port trains it on 2 ranks (tests/helpers/torch_dist.py: each rank a
  process of its own, ``init_method=file://``, one thread, a 120 s
  deadline) with plain data parallelism and with FSDP
  (``parallel.fsdp=True``, ``fsdp_min_leaf_size=1024`` so that most
  leaves shard), from JAX's init (a ``load_from`` checkpoint), the cls
  batch augments off (ROADMAP C15), the same CDN noise for the global det
  batch fed to each package's det step (each rank its rows). Every loss
  term and ``grad_norm`` per iteration (the port's summed over the ranks
  by ``LogHook`` into ``metrics.jsonl``) within the train-slice
  tolerances (rtol 2e-3 / atol 2e-4), the final parameters within
  2e-4 + 5e-3 * |w|.
* The same two runs against the port's one process on the global batch
  (``samples_per_gpu`` doubled), with drop path on and the CDN noise drawn
  by the step's generator: each rank draws for the global batch and keeps
  its rows, so the runs agree within the same tolerances.
* The FSDP run's ``iter_4.pth`` (rank 0's write of the gathered state)
  loads into one process bit-equal to the state gathered at the end, the
  optimizer's moments too.
* SIGTERM to rank 1 alone at step 3 of 8: both ranks stop at step 3 and
  one checkpoint, ``iter_3.pth``, is written.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rscotr_tpu.apis as jax_apis
from rscotr_tpu.config import Config
from rscotr_tpu.config.registry import HOOKS as JAX_HOOKS
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.engine.hooks import Hook as JaxHook
from rscotr_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.torch_dist import (ROOT, TINY, run_ranks,  # noqa: E402
                                task_train, with_noise)

ITERS = 4
BASE = {"model.train_cfg.cls.augments": [], "log_config.interval": 1,
        "checkpoint_config.interval": 100}
FSDP = {"parallel.fsdp": True, "parallel.fsdp_min_leaf_size": 1024}
GLOBAL = {"data.resisc.data.samples_per_gpu": 8,
          "data.dior.data.samples_per_gpu": 2,
          "data.potsdam.data.samples_per_gpu": 4}


class _JaxLossRecorder(JaxHook):
    priority = 80
    logs = []

    def after_train_iter(self, runner):
        self.logs.append({k: float(v) for k, v in runner.log_vars.items()
                          if k not in ("data_time", "time")})


if "DistJaxLossRecorder" not in JAX_HOOKS:
    JAX_HOOKS.register_module(name="DistJaxLossRecorder")(_JaxLossRecorder)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's 4 iterations on a 2-device mesh; its init saved as the port's
    ``load_from`` checkpoint."""
    tmp = tmp_path_factory.mktemp("jax")
    jcfg = Config.fromfile(TINY)
    jcfg.merge_from_dict(dict(BASE, custom_hooks=[
        dict(type="DistJaxLossRecorder")]))
    jcfg = jax_load_data_cfg(jcfg, config_root=ROOT)
    cdn = jax_apis.make_step_config(jcfg).cdn
    inits = []
    real_init, real_make = jax_apis.init_model_params, \
        jax_apis.make_train_step

    def init_params(model, cfg, seed=0):
        params = jax.jit(lambda k: model.init(
            k, cls_img=jnp.zeros((1, 64, 64, 3)),
            det_img=jnp.zeros((1, 128, 128, 3)),
            det_img_hw=jnp.array([[128, 128]], jnp.int32),
            seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(seed))
        inits.append(jax.tree.map(lambda x: np.asarray(x).copy(), params))
        return params

    _JaxLossRecorder.logs.clear()
    jax_apis.init_model_params = init_params
    jax_apis.make_train_step = with_noise(real_make, cdn, 2,
                                          asarray=jnp.asarray)
    try:
        with jax.default_matmul_precision("highest"):
            jrunner = jax_apis.train_model(
                jcfg, str(tmp / "wd"), validate=False,
                max_iters_override=ITERS, num_devices=2)
    finally:
        jax_apis.init_model_params = real_init
        jax_apis.make_train_step = real_make
    init = build_model(load_cfg(TINY)["model"], device="cpu")
    init.load_state_dict(state_dict_from_jax(inits[0]["params"]),
                         strict=True)
    final = state_dict_from_jax(jax.tree.map(
        lambda x: np.asarray(x).copy(), jrunner.params["params"]))
    return dict(logs=list(_JaxLossRecorder.logs), final=final,
                load_from=save_checkpoint(str(tmp / "init"), 0, init))


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """The port's 2-rank DP and FSDP runs from JAX's init, with JAX's
    noise."""
    out = {}
    for name, extra in (("dp", {}), ("fsdp", FSDP)):
        tmp = tmp_path_factory.mktemp(name)
        ranks = run_ranks(
            "train", 2, tmp, opts=dict(BASE, load_from=jax_run["load_from"],
                                       **extra),
            work_dir=str(tmp / "wd"), max_iters=ITERS, noise_b=2)
        out[name] = dict(ranks=ranks, wd=tmp / "wd")
    return out


def _check_logs(got, want):
    assert [r["step"] for r in got] == list(range(1, ITERS + 1))
    for i, (g, w) in enumerate(zip(got, want)):
        keys = set(w)
        assert keys <= set(g), (i, sorted(keys - set(g)))
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-3, atol=2e-4,
                                       err_msg=f"iteration {i + 1} {k}")


def _check_params(got, want):
    bad = []
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        err = np.abs(g - w) - (2e-4 + 5e-3 * np.abs(w))
        if (err > 0).any():
            j = np.unravel_index(np.argmax(err), err.shape)
            bad.append(f"{name}{list(j)}: got {g[j]:.6g} want {w[j]:.6g}")
    assert not bad, "final params diverged:\n" + "\n".join(bad[:20])


@pytest.mark.parametrize("kind", ["dp", "fsdp"])
def test_two_ranks_match_jax_train_model(jax_run, port_runs, kind):
    ranks = port_runs[kind]["ranks"]
    assert [r["step"] for r in ranks] == [ITERS, ITERS]
    assert [r["sharded"] for r in ranks] == [kind == "fsdp"] * 2
    assert [r["threads"] for r in ranks] == [1, 1]
    _check_logs(ranks[0]["logs"], jax_run["logs"])
    _check_params(ranks[0]["state"], jax_run["final"])


@pytest.mark.parametrize("kind", ["dp", "fsdp"])
def test_two_ranks_match_one_process(kind, tmp_path, monkeypatch):
    """Drop path on, CDN noise from the step generator: every per-sample
    draw is the global batch's, each rank keeping its rows."""
    opts = dict(BASE, **{"model.backbone.drop_path_rate": 0.3})
    os.makedirs(tmp_path / "ranks")
    ranks = run_ranks("train", 2, tmp_path / "ranks",
                      opts=dict(opts, **(FSDP if kind == "fsdp" else {})),
                      work_dir=str(tmp_path / "ranks" / "wd"),
                      max_iters=ITERS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        one = task_train(dict(opts, **GLOBAL), str(tmp_path / "one"), ITERS)
    finally:
        torch.set_num_threads(threads)
    want = [{k: v for k, v in r.items() if k not in ("time", "data_time")}
            for r in one["logs"]]
    _check_logs(ranks[0]["logs"], want)
    _check_params(ranks[0]["state"], one["state"])
    for part in ("mu", "nu"):
        for k, v in one["opt"][part].items():
            np.testing.assert_allclose(ranks[0]["opt"][part][k], v,
                                       rtol=2e-3, atol=1e-6, err_msg=k)
    assert ranks[0]["opt"]["count"] == one["opt"]["count"]


def test_fsdp_checkpoint_reloads_bit_equal(port_runs):
    ranks, wd = port_runs["fsdp"]["ranks"], port_runs["fsdp"]["wd"]
    assert sorted(f for f in os.listdir(wd) if f.endswith(".pth")) == \
        ["iter_4.pth"]
    ck = load_checkpoint(str(wd / "iter_4.pth"))
    gathered = ranks[0]["state"]
    assert set(ck["state_dict"]) == set(gathered)
    for k, v in gathered.items():
        assert torch.equal(ck["state_dict"][k], v), k
    model = build_model(load_cfg(TINY)["model"], device="cpu")
    load_checkpoint(str(wd / "iter_4.pth"), model=model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, gathered[k]), k
    for part in ("mu", "nu"):
        for k, v in ranks[0]["opt"][part].items():
            assert torch.equal(ck["optimizer"][part][k], v), (part, k)
    assert ck["optimizer"]["step"] == ITERS
    assert ck["meta"]["iter"] == ITERS


def test_sigterm_to_one_rank_stops_both(tmp_path):
    ranks = run_ranks("train", 2, tmp_path, opts=dict(BASE),
                      work_dir=str(tmp_path / "wd"), max_iters=8,
                      sigterm_at=(1, 3))
    assert [r["step"] for r in ranks] == [3, 3]
    assert [r["preempted"] for r in ranks] == [True, True]
    assert [f for f in ranks[0]["files"] if f.endswith(".pth")] == \
        ["iter_3.pth"]
