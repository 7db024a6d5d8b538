"""The co-training loop end to end against the JAX package's, on
configs/multi/MTL_tiny_synthetic.py.

* Order: each package's ``IterBasedRunner`` over its own
  ``build_multidataloader``, with stub steps that record a digest of every
  batch (JAX's scan stubs record each batch of a stacked group) and hooks
  that record each step's log-var names and their own firings: the
  sequences are equal at K = 1 and K = 4 (JAX's grouped order), from step 0
  and from a resume at step 3, under round_robin and under the exhaust-all
  constant strategy (whose epoch end re-seeds the loaders). Nothing
  compiles. A resumed run starts the data stream again in both packages
  (ROADMAP C9).
* Losses: ``train_model`` of the tiny config in both packages for 6
  iterations (cls, det, seg, cls, det, seg), ``cls_use_augments=False``,
  ``validate=False``, from the same weights (JAX's init, handed to the
  port as ``load_from``), with the same CDN noise fed to each package's
  det step as ``dn_noise_*`` batch entries. Tolerances are those of
  tests/test_torch_port_train_slice.py: every loss term and ``grad_norm``
  per iteration at rtol 2e-3 / atol 2e-4, the final parameters at 2e-4 +
  5e-3 * |w|.
* ROADMAP C10: ``load_task_pretrain`` from a tiny standalone-DINO
  checkpoint copies backbone, neck and bbox_head and leaves
  ``shared_encoder`` as it was, in both packages, bit for bit.
* The CLI: the port's ``tools/train.py --device cpu`` writes
  ``iter_6.pth``, ``last_checkpoint`` and ``metrics.jsonl`` (with the eval
  hook's metrics), resumes from ``iter_6.pth`` with the model and the
  optimizer state bit-equal, and the port's ``tools/test.py`` reads the
  checkpoint.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rscotr_tpu.apis as jax_apis
import rscotr_tpu_torch.engine.train_step as port_train_step
from rscotr_tpu.config import Config
from rscotr_tpu.config.registry import HOOKS as JAX_HOOKS
from rscotr_tpu.data import build_datasets as jax_build_datasets
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.data.build import build_multidataloader as jax_build_mdl
from rscotr_tpu.engine import save_checkpoint as jax_save_checkpoint
from rscotr_tpu.engine.hooks import Hook as JaxHook
from rscotr_tpu.engine.runner import IterBasedRunner as JaxRunner
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch.apis import (load_task_pretrain, make_step_config,
                                   train_model)
from rscotr_tpu_torch.data.build import (build_datasets,
                                         build_multidataloader,
                                         load_data_cfg)
from rscotr_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from rscotr_tpu_torch.engine.hooks import Hook
from rscotr_tpu_torch.engine.runner import IterBasedRunner
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.tools import test as test_cli
from rscotr_tpu_torch.tools import train as train_cli
from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
from rscotr_tpu_torch.utils.convert import state_dict_from_jax
from rscotr_tpu_torch.utils.registry import HOOKS
from rscotr_tpu_torch.utils.rng import mix_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")


def _cfgs(opts):
    jcfg = Config.fromfile(TINY)
    jcfg.merge_from_dict(opts)
    jcfg = jax_load_data_cfg(jcfg, config_root=ROOT)
    cfg = load_data_cfg(merge_from_dict(load_cfg(TINY), opts),
                        config_root=ROOT, filename=TINY)
    return jcfg, cfg


# ---------------------------------------------------------------------------
# order
# ---------------------------------------------------------------------------

def _digest(batch):
    h = hashlib.sha1()
    for k in sorted(batch):
        v = np.asarray(batch[k])
        h.update(f"{k}{v.shape}{v.dtype}".encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


class _Rec:
    """Records each step's loss names and whether its interval fires."""

    def __init__(self, out, interval):
        self.out, self.interval = out, interval

    def after_train_iter(self, runner):
        self.out.append((runner.step, tuple(sorted(
            k for k in runner.log_vars if k.endswith(".loss"))),
            runner.step % self.interval == 0))


class _JaxRec(_Rec, JaxHook):
    pass


class _PortRec(_Rec, Hook):
    pass


def _run_order(strategy, K, start, max_iters, seed=2):
    """(batch digests, hook records) of each package's runner."""
    jcfg, cfg = _cfgs({"iteration_strategy": {"type": strategy}})
    out = {}

    seen_j, rec_j = [], []

    def jstep(params, opt_state, batch, rng):
        seen_j.append(_digest(batch))
        return params, opt_state, {"loss": np.float32(0)}

    def jscan(params, opt_state, batches, root_key, idxs):
        n = len(idxs)
        for i in range(n):
            seen_j.append(_digest({k: np.asarray(v)[i]
                                   for k, v in batches.items()}))
        return params, opt_state, {"loss": np.zeros(n, np.float32)}

    tasks = ("cls", "det", "seg")
    jr = JaxRunner({t: jstep for t in tasks}, {}, {}, max_iters,
                   rng_seed=seed, start_step=start,
                   scan_steps={t: jscan for t in tasks} if K > 1 else None,
                   steps_per_dispatch=K, handle_preemption=False)
    jr.register_hook(_JaxRec(rec_j, 6))
    jr.register_hook(type("B", (JaxHook,), {"interval": 10})())
    jr.run(jax_build_mdl(jcfg, jax_build_datasets(jcfg.data), seed=seed))
    out["jax"] = (seen_j, rec_j)

    seen_p, rec_p, gens = [], [], []

    def pstep(batch, generator):
        seen_p.append(_digest(batch))
        gens.append(generator.initial_seed())
        return {"loss": torch.zeros(())}

    pr = IterBasedRunner({t: pstep for t in tasks}, max_iters=max_iters,
                         rng_seed=seed, start_step=start,
                         steps_per_dispatch=K, handle_preemption=False)
    pr.register_hook(_PortRec(rec_p, 6))
    pr.register_hook(type("B", (Hook,), {"interval": 10})())
    pr.run(build_multidataloader(cfg, build_datasets(cfg["data"]),
                                 seed=seed))
    out["port"] = (seen_p, rec_p)
    assert gens == [mix_seed(seed, s) for s in range(start, max_iters)]
    return out


ORDER_CASES = [("round_robin", 1, 0, 20), ("round_robin", 4, 0, 20),
               ("round_robin", 4, 3, 20), ("round_robin", 1, 3, 20),
               ("constant", 1, 0, 40), ("constant", 4, 0, 40)]


@pytest.mark.parametrize("strategy,K,start,max_iters", ORDER_CASES)
def test_order_matches_jax(strategy, K, start, max_iters):
    """Every step's batch, its task and dataset, and the hook firings equal
    JAX's, in the strategy's order (K = 1) and in JAX's grouped order
    (K = 4); the exhaust-all cases cross an epoch end (32 batches)."""
    out = _run_order(strategy, K, start, max_iters)
    (seen_j, rec_j), (seen_p, rec_p) = out["jax"], out["port"]
    assert len(seen_p) == len(rec_p) == max_iters - start
    assert seen_p == seen_j
    assert rec_p == rec_j
    tasks = [r[1][0].split(".")[0] for r in rec_p]
    # the data stream starts at its head whatever the start step (C9)
    assert tasks[0] == "cls"
    if K == 4:
        assert tasks[:2] == ["cls", "cls"]


def test_resume_restarts_the_data_stream_in_both():
    """ROADMAP C9: a run resumed at step 3 draws the batches a fresh run
    draws from step 0, in both packages (neither calls set_step)."""
    fresh = _run_order("round_robin", 1, 0, 12)
    resumed = _run_order("round_robin", 1, 3, 12)
    for side in ("jax", "port"):
        assert resumed[side][0] == fresh[side][0][:9]
        assert resumed[side][0] != fresh[side][0][3:]


# ---------------------------------------------------------------------------
# train_model, 6 iterations, both packages
# ---------------------------------------------------------------------------

class _LossRecorder:
    """A custom hook (``cfg.custom_hooks``) that records every step's loss
    terms and grad_norm as floats in ``logs``, tagged by package."""
    priority = 80
    logs = []

    def after_train_iter(self, runner):
        self.logs.append((self.side, runner.step, {
            k: float(v) for k, v in runner.log_vars.items()
            if k not in ("data_time", "time")}))


for _name, _side, _reg, _base in (
        ("PortLossRecorder", "port", HOOKS, Hook),
        ("JaxLossRecorder", "jax", JAX_HOOKS, JaxHook)):
    if _name not in _reg:
        _reg.register_module(name=_name)(
            type(_name, (_LossRecorder, _base), {"side": _side}))


def _noise(j, cdn):
    shape = (1, 2 * cdn.num_groups, cdn.single_pad)
    rng = np.random.default_rng(100 + j)
    return dict(
        dn_noise_p=rng.uniform(size=shape).astype(np.float32),
        dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
        dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                       ).astype(np.float32),
        dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))


def _with_noise(make, cdn, asarray):
    """``make_train_step`` whose det steps get the j-th noise draw."""
    calls = []

    def wrapped(model, optimizer, task, cfg, mask=None, **kw):
        step = make(model, optimizer, task, cfg, mask, **kw)
        if task != "det":
            return step

        def det_step(*args):
            args = list(args)
            i = 2 if len(args) == 4 else 0   # JAX: (params, opt, batch, rng)
            args[i] = dict(args[i], **{k: asarray(v) for k, v in
                                       _noise(len(calls), cdn).items()})
            calls.append(1)
            return step(*args)
        return det_step
    return wrapped


@pytest.fixture(scope="module", autouse=True)
def _quiet_host():
    """Both packages' metric sinks skip TensorBoard when it does not
    import (here it would import tensorflow, which the tests do not need);
    torch keeps to 2 threads, so that the test workers beside this one do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    opts = {"model.train_cfg.cls.augments": [],
            "custom_hooks": [dict(type="JaxLossRecorder")]}
    jcfg, _ = _cfgs(opts)
    cdn = jax_apis.make_step_config(jcfg).cdn
    _LossRecorder.logs.clear()
    inits = []
    real_init, real_make = jax_apis.init_model_params, \
        jax_apis.make_train_step

    def init_params(model, cfg, seed=0):
        # JAX's init, jitted at small shapes (the eager init_model_params
        # takes a minute on the CPU); a host copy is kept, since the jitted
        # steps donate the arrays they are given
        params = jax.jit(lambda k: model.init(
            k, cls_img=jnp.zeros((1, 64, 64, 3)),
            det_img=jnp.zeros((1, 128, 128, 3)),
            det_img_hw=jnp.array([[128, 128]], jnp.int32),
            seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(seed))
        inits.append(jax.tree.map(lambda x: np.asarray(x).copy(), params))
        return params

    jax_apis.init_model_params = init_params
    jax_apis.make_train_step = _with_noise(real_make, cdn, jnp.asarray)
    try:
        with jax.default_matmul_precision("highest"):
            jrunner = jax_apis.train_model(
                jcfg, str(tmp / "jax"), validate=False,
                max_iters_override=6, num_devices=1)
    finally:
        jax_apis.init_model_params = real_init
        jax_apis.make_train_step = real_make

    # the port starts from JAX's init, as a load_from checkpoint
    _, cfg = _cfgs({"model.train_cfg.cls.augments": [],
                    "custom_hooks": [dict(type="PortLossRecorder")]})
    assert not make_step_config(cfg).cls_use_augments
    init = build_model(cfg["model"], device="cpu")
    init.load_state_dict(state_dict_from_jax(inits[0]["params"]),
                         strict=True)
    cfg["load_from"] = save_checkpoint(str(tmp / "init"), 0, init)
    real_port = port_train_step.make_train_step
    port_train_step.make_train_step = _with_noise(real_port, cdn,
                                                  np.asarray)
    try:
        runner = train_model(cfg, str(tmp / "port"), validate=False,
                             max_iters_override=6, device="cpu")
    finally:
        port_train_step.make_train_step = real_port
    final_jax = state_dict_from_jax(jax.tree.map(
        lambda x: np.asarray(x).copy(), jrunner.params["params"]))
    return dict(logs=list(_LossRecorder.logs), runner=runner,
                final_jax=final_jax, tmp=tmp)


@pytest.mark.parametrize("i", range(6))
def test_train_model_losses_match_jax(loop, i):
    logs = {side: [(s, lv) for sd, s, lv in loop["logs"] if sd == side]
            for side in ("jax", "port")}
    assert [s for s, _ in logs["port"]] == [s for s, _ in logs["jax"]] == \
        list(range(1, 7))
    want, got = logs["jax"][i][1], logs["port"][i][1]
    assert set(got) == set(want), (sorted(got), sorted(want))
    task = ("cls", "det", "seg")[i % 3]
    assert any(k.startswith(task + ".") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-4,
                                   err_msg=f"iteration {i + 1} {k}")


def test_train_model_final_params_match_jax(loop):
    sd = loop["runner"].model.state_dict()
    bad = []
    for name, w in loop["final_jax"].items():
        g, w = sd[name].numpy(), w.numpy()
        err = np.abs(g - w) - (2e-4 + 5e-3 * np.abs(w))
        if (err > 0).any():
            j = np.unravel_index(np.argmax(err), err.shape)
            bad.append(f"{name}{list(j)}: got {g[j]:.6g} want {w[j]:.6g}")
    assert not bad, "final params diverged:\n" + "\n".join(bad[:20])
    assert loop["runner"].step == 6
    assert loop["runner"].optimizer.step == 6
    assert os.path.isfile(loop["tmp"] / "port" / "iter_6.pth")


# ---------------------------------------------------------------------------
# ROADMAP C10: load_task_pretrain from a standalone DINO
# ---------------------------------------------------------------------------

def _random_tree(shapes, rng):
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype),
                        shapes)


def test_task_pretrain_leaves_shared_encoder_in_both(tmp_path):
    cfg = load_cfg(TINY)
    m = cfg["model"]
    dino_cfg = dict(type="DINO", backbone=m["backbone"], neck=m["neck"],
                    encoder=m["shared_encoder"], bbox_head=m["bbox_head"])
    key = jax.random.key(0)
    hw = jnp.array([[64, 64]], jnp.int32)
    dino_shapes = jax.eval_shape(lambda k: jax_build_model(dino_cfg).init(
        k, jnp.zeros((1, 64, 64, 3)), hw), key)
    mtl_shapes = jax.eval_shape(lambda k: jax_build_model(m).init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 64, 64, 3)), det_img_hw=hw,
        seg_img=jnp.zeros((1, 64, 64, 3))), key)
    rng = np.random.default_rng(0)
    dino = _random_tree(dino_shapes["params"], rng)
    mtl = _random_tree(mtl_shapes["params"], rng)
    jax_ck = jax_save_checkpoint(str(tmp_path / "jax"), 0,
                                 {"params": dino})
    dmodel = build_model(dino_cfg, device="cpu")
    dmodel.load_state_dict(state_dict_from_jax(dino), strict=True)
    port_ck = save_checkpoint(str(tmp_path / "port"), 0, dmodel)

    want = jax_apis.load_task_pretrain({"params": mtl}, jax_ck)["params"]
    model = build_model(m, device="cpu")
    model.load_state_dict(state_dict_from_jax(mtl), strict=True)
    got = load_task_pretrain(model, port_ck).state_dict()

    want_sd = state_dict_from_jax(want)
    before = state_dict_from_jax(mtl)
    dino_sd = state_dict_from_jax(dino)
    assert sorted(got) == sorted(want_sd)
    for name, w in want_sd.items():
        assert torch.equal(got[name], w), name
        top = name.split(".")[0]
        if top in ("backbone", "neck", "bbox_head"):
            assert torch.equal(w, dino_sd[name]), name
        else:   # shared_encoder and the cls / seg heads keep the MTL's
            assert torch.equal(w, before[name]), name
    assert any(n.startswith("shared_encoder.") for n in want_sd)
    assert any(n.startswith("encoder.") for n in dino_sd)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_writes_resumes_and_feeds_test_cli(tmp_path):
    wd = str(tmp_path / "wd")
    # the eval hook fires at the last step, over val sets cut to 2 images
    # (or 4) each
    runner = train_cli.main([TINY, "--work-dir", wd, "--max-iters", "6",
                             "--device", "cpu", "--cfg-options",
                             "data.resisc.data.val.length=4",
                             "data.dior.data.val.length=2",
                             "data.potsdam.data.val.length=2"])
    assert runner.step == 6 and not runner.preempted
    for f in ("iter_6.pth", "last_checkpoint", "metrics.jsonl", "train.log",
              "best_checkpoint.pth", "MTL_tiny_synthetic.py"):
        assert os.path.isfile(os.path.join(wd, f)), f
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == [6]
    assert {"seg.potsdam.loss", "grad_norm", "data_time", "time",
            "val/resisc.accuracy_top-1", "val/dior.bbox_mAP",
            "val/potsdam.mFscore"} <= set(lines[0])
    saved = load_checkpoint(os.path.join(wd, "iter_6.pth"))
    assert saved["meta"]["iter"] == 6
    assert set(saved["meta"]["CLASSES"]) == {"resisc", "dior", "potsdam"}

    class Snap(Hook):
        def before_run(self, runner):
            self.model = {k: v.clone()
                          for k, v in runner.model.state_dict().items()}
            self.opt = runner.optimizer.state_dict()
            self.start = runner.step

    snap = Snap()
    resumed = train_cli.main(
        [TINY, "--work-dir", wd, "--max-iters", "8", "--device", "cpu",
         "--no-validate", "--resume-from",
         os.path.join(wd, "iter_6.pth")], hooks=[snap])
    assert snap.start == 6 and resumed.step == 8
    for k, v in saved["state_dict"].items():
        assert torch.equal(snap.model[k], v), k
    assert snap.opt["step"] == saved["optimizer"]["step"] == 6
    assert snap.opt["count"] == saved["optimizer"]["count"]
    for part in ("mu", "nu"):
        for k, v in saved["optimizer"][part].items():
            assert torch.equal(snap.opt[part][k], v), (part, k)
    assert load_checkpoint(os.path.join(wd, "latest"))["meta"]["iter"] == 8

    out = str(tmp_path / "m.json")
    metrics = test_cli.main([TINY, os.path.join(wd, "iter_6.pth"),
                             "--device", "cpu", "--max-batches", "1",
                             "--eval-out", out])
    assert {"resisc.accuracy_top-1", "dior.bbox_mAP",
            "potsdam.mFscore"} <= set(metrics)
    with open(out) as f:
        assert json.load(f) == metrics


def test_train_cli_refuses_a_launcher(tmp_path):
    """``--launcher jax`` (a TPU pod's) is refused with the port's command
    line; ``num_devices`` other than the process count (one process, no
    group) says how to launch one process per device. ``--launcher
    pytorch`` runs in tests/test_torch_port_dist_tools.py."""
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train_cli.main([TINY, "--work-dir", str(tmp_path), "--launcher",
                        "jax", "--device", "cpu"])
    with pytest.raises(ValueError, match="nproc_per_node 2"):
        train_model(load_cfg(TINY), str(tmp_path), num_devices=2,
                    device="cpu")


def test_step_config_follows_the_augments_option():
    for opts, want in (({}, True),
                       ({"model.train_cfg.cls.augments": []}, False)):
        jcfg, cfg = _cfgs(opts)
        assert make_step_config(cfg).cls_use_augments is want
        assert jax_apis.make_step_config(jcfg).cls_use_augments is want
