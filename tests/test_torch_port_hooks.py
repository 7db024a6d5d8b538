"""The port's runner hooks and schedule helpers (counterparts of
tests/test_hooks.py and tests/test_epoch_runner.py of the JAX package):
checkpoint pruning of ``iter_N.pth`` files, async saves, custom hooks in
priority order, ``NumClassCheckHook``, preemption, ``KeyIndicator``, the
eval hook's save-best against JAX's on one metric sequence,
``resolve_schedule`` against JAX's for every config, the initial
checkpoint's precedence and the fp16 mapping. No model is built: the
"model" is a small ``nn.Linear``.
"""

import glob
import json
import os
import signal
import types

import numpy as np
import pytest
import torch

from rscotr_tpu.apis import derive_shapes as jax_derive_shapes
from rscotr_tpu.apis import resolve_schedule as jax_resolve_schedule
from rscotr_tpu.config import Config
from rscotr_tpu.engine import KeyIndicator as JaxKeyIndicator
from rscotr_tpu.engine import \
    MultiDatasetsEvalHook as JaxMultiDatasetsEvalHook
from rscotr_tpu_torch.apis import (apply_fp16_cfg, derive_shapes,
                                   resolve_init_checkpoint, resolve_schedule)
from rscotr_tpu_torch.engine.checkpoint import (CheckpointWriter,
                                                find_latest_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint)
from rscotr_tpu_torch.engine.hooks import (CheckpointHook, Hook,
                                           KeyIndicator,
                                           MultiDatasetsEvalHook,
                                           NumClassCheckHook,
                                           build_custom_hooks)
from rscotr_tpu_torch.engine.runner import IterBasedRunner
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.registry import HOOKS
from rscotr_tpu_torch.utils.rng import (RngPool, mix_seed, set_random_seed,
                                       step_generator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))
RUNNER_CONFIGS = [p for p in CONFIGS
                  if load_cfg(os.path.join(ROOT, p)).get("runner")]
# configs whose data section names tasks (not the _base_ dataset files)
DATA_CONFIGS = [p for p in CONFIGS if all(
    isinstance(e, dict) and "task" in e
    for e in load_cfg(os.path.join(ROOT, p)).get("data", {None: 0}).values())]


def _model():
    torch.manual_seed(0)
    return torch.nn.Linear(2, 3)


def _runner(step=0, **kw):
    return types.SimpleNamespace(model=_model(), optimizer=None,
                                 max_iters=100, step=step, preempted=False,
                                 **kw)


def _iters(wd):
    return sorted(f for f in os.listdir(wd) if f.startswith("iter_"))


# ---------------------------------------------------------------------------
# CheckpointHook
# ---------------------------------------------------------------------------

def test_max_keep_ckpts_prunes_oldest(tmp_path):
    """Only the newest N iter_N.pth survive; best_checkpoint.pth is never
    pruned and last_checkpoint names the newest."""
    wd = str(tmp_path / "wd")
    runner = _runner()
    save_checkpoint(wd, 7, runner.model, meta={"best_score": 1.0},
                    name="best_checkpoint")
    hook = CheckpointHook(interval=1, work_dir=wd, max_keep_ckpts=2)
    for step in (1, 2, 3, 4):
        runner.step = step
        hook.after_train_iter(runner)
    assert _iters(wd) == ["iter_3.pth", "iter_4.pth"]
    assert os.path.isfile(os.path.join(wd, "best_checkpoint.pth"))
    assert find_latest_checkpoint(wd).endswith("iter_4.pth")


def test_prune_spares_checkpoints_ahead_of_current_step(tmp_path):
    wd = str(tmp_path / "wd")
    runner = _runner()
    save_checkpoint(wd, 50, runner.model)   # left by an earlier run
    hook = CheckpointHook(interval=1, work_dir=wd, max_keep_ckpts=1)
    for step in (1, 2):
        runner.step = step
        hook.after_train_iter(runner)
    assert _iters(wd) == ["iter_2.pth", "iter_50.pth"]


def test_default_keeps_all_and_saves_on_interval_and_last(tmp_path):
    wd = str(tmp_path / "wd")
    runner = _runner()
    runner.max_iters = 7
    hook = CheckpointHook(interval=3, work_dir=wd)
    for step in range(1, 8):
        runner.step = step
        hook.after_train_iter(runner)
    assert _iters(wd) == ["iter_3.pth", "iter_6.pth", "iter_7.pth"]


def test_async_save_commits_and_loads(tmp_path):
    """With a writer the call returns with the state copied to the host;
    after the drain the file, its meta and the pointer are complete, and
    an update made meanwhile is not in the file."""
    wd = str(tmp_path / "wd")
    model = _model()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    writer = CheckpointWriter()
    path = save_checkpoint(wd, 3, model, meta={"CLASSES": {"d": ["a"]}},
                           writer=writer)
    with torch.no_grad():
        model.weight.add_(1.0)
    writer.wait()
    ck = load_checkpoint(path)
    assert ck["meta"] == {"CLASSES": {"d": ["a"]}, "iter": 3}
    for k, v in want.items():
        assert torch.equal(ck["state_dict"][k], v)
    assert find_latest_checkpoint(wd) == path


def test_async_hook_prunes_and_drains_on_after_run(tmp_path):
    wd = str(tmp_path / "wd")
    hook = CheckpointHook(interval=1, work_dir=wd, max_keep_ckpts=2,
                          async_save=True)
    runner = _runner()
    for step in (1, 2, 3):
        runner.step = step
        hook.after_train_iter(runner)
    hook.after_run(runner)
    assert hook.writer._thread is None and hook.writer._error is None
    assert _iters(wd) == ["iter_2.pth", "iter_3.pth"]


def test_async_failure_surfaces_on_next_wait(tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_bytes(b"")   # the work dir is a FILE: the write fails
    writer = CheckpointWriter()
    save_checkpoint(str(blocker), 1, _model(), writer=writer)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        writer.wait()
    writer.wait()   # the error is cleared: the next wait is a no-op
    hook = CheckpointHook(interval=1, work_dir=str(blocker),
                          async_save=True)
    runner = _runner(step=1)
    hook.after_train_iter(runner)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        hook.after_run(runner)


# ---------------------------------------------------------------------------
# custom hooks, NumClassCheckHook
# ---------------------------------------------------------------------------

if "PortRecordingHook" not in HOOKS:
    @HOOKS.register_module()
    class PortRecordingHook(Hook):
        def __init__(self, tag="x"):
            self.tag = tag


def test_build_custom_hooks_from_cfg():
    hooks = build_custom_hooks([
        dict(type="PortRecordingHook", tag="a", priority="VERY_HIGH"),
        dict(type="PortRecordingHook", tag="b", priority=75),
        dict(type="NumClassCheckHook")])
    assert [h.priority for h in hooks] == [10, 75, 50]
    assert hooks[0].tag == "a" and isinstance(hooks[2], NumClassCheckHook)
    assert build_custom_hooks(None) == []


def _fake_step(batch, generator):
    return {"loss": torch.zeros(()), "grad_norm": torch.ones(())}


class _Loader:
    def __init__(self, n, task="cls"):
        self.n, self.task = n, task

    def __iter__(self):
        return ({"task": self.task, "dataset_name": "d",
                 "x": np.full(1, i, np.float32)} for i in range(self.n))

    def seed_sampler(self, epoch):
        pass


def test_custom_hooks_fire_in_priority_order():
    order = []

    class Rec(Hook):
        def __init__(self, name, priority):
            self.name, self.priority = name, priority

        def before_run(self, runner):
            order.append(("before", self.name))

        def after_train_iter(self, runner):
            order.append(("iter", self.name))

        def after_run(self, runner):
            order.append(("after", self.name))

    runner = IterBasedRunner({"cls": _fake_step}, max_iters=1, prefetch=0)
    runner.register_hook(Rec("late", 90))
    runner.register_hook(Rec("early", 10))
    runner.run(_Loader(5))
    assert order == [("before", "early"), ("before", "late"),
                     ("iter", "early"), ("iter", "late"),
                     ("after", "early"), ("after", "late")]


def test_runner_log_vars_and_step_generators():
    """Log vars are named {task}.{dataset}.{loss}, grad_norm bare, beside
    data_time and time; step s draws from a generator seeded by (seed, s)
    alone; with prefetch the batches keep their order."""
    seen, logs = [], []

    def step(batch, generator):
        seen.append((int(batch["x"][0]), generator.initial_seed()))
        return {"loss": torch.zeros(()), "grad_norm": torch.ones(())}

    class Log(Hook):
        def after_train_iter(self, runner):
            logs.append(dict(runner.log_vars))

    runner = IterBasedRunner({"cls": step}, max_iters=8, rng_seed=11,
                             start_step=2, prefetch=2)
    runner.register_hook(Log())
    runner.run(_Loader(100))
    assert runner.step == 8
    assert seen == [(i, mix_seed(11, 2 + i)) for i in range(6)]
    assert all(sorted(lv) == ["cls.d.loss", "data_time", "grad_norm",
                              "time"] for lv in logs)
    assert all(lv["time"] >= lv["data_time"] >= 0 for lv in logs)


def test_num_class_check_hook():
    ds_ok = types.SimpleNamespace(task="det",
                                  CLASSES=[f"c{i}" for i in range(20)])
    runner = types.SimpleNamespace(
        datasets={"dior": ds_ok},
        model_cfg={"bbox_head": {"num_classes": 20}})
    NumClassCheckHook().before_run(runner)
    runner.model_cfg = {"bbox_head": {"num_classes": 19}}
    with pytest.raises(ValueError, match="dior.*20 CLASSES.*19"):
        NumClassCheckHook().before_run(runner)
    runner.model_cfg = {"decode_head": {"num_classes": 6}}
    runner.datasets = {"p": types.SimpleNamespace(task="seg",
                                                  CLASSES=list("abcde"))}
    with pytest.raises(ValueError, match="p.*5 CLASSES.*6"):
        NumClassCheckHook().before_run(runner)
    runner.datasets = {"d": types.SimpleNamespace(task="cls", CLASSES=None)}
    NumClassCheckHook().before_run(runner)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_sigterm_checkpoints_and_stops(tmp_path):
    """SIGTERM mid-run stops the loop at the next step boundary, the
    checkpoint hook writes that step's checkpoint, and the previous handler
    comes back."""
    class SendSigterm(Hook):
        def after_train_iter(self, runner):
            if runner.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    wd = str(tmp_path / "wd")
    prev = signal.getsignal(signal.SIGTERM)
    runner = IterBasedRunner({"cls": _fake_step}, model=_model(),
                             max_iters=50, prefetch=0)
    runner.register_hook(SendSigterm())
    runner.register_hook(CheckpointHook(interval=100, work_dir=wd))
    runner.run(_Loader(100))
    assert runner.preempted and runner.step == 2
    latest = find_latest_checkpoint(wd)
    assert latest.endswith("iter_2.pth")
    assert load_checkpoint(latest)["meta"]["iter"] == 2
    assert signal.getsignal(signal.SIGTERM) is prev


def test_clean_finish_is_not_preempted(tmp_path):
    wd = str(tmp_path / "wd")
    runner = IterBasedRunner({"cls": _fake_step}, model=_model(),
                             max_iters=3, prefetch=0)
    runner.register_hook(CheckpointHook(interval=100, work_dir=wd))
    runner.run(_Loader(100))
    assert not runner.preempted and runner.step == 3
    assert _iters(wd) == ["iter_3.pth"]


# ---------------------------------------------------------------------------
# KeyIndicator and the eval hook's save-best
# ---------------------------------------------------------------------------

def test_key_indicator_matches_jax():
    weights = {"a.acc": 1.0, "b.map": 100.0}
    for m in ({"a.acc": 0.9, "b.map": 0.5}, {"a.acc": 3.0, "b.map": 0.0}):
        assert KeyIndicator(weights)(m) == JaxKeyIndicator(weights)(m) == \
            (1.0 * m["a.acc"] + 100.0 * m["b.map"]) / 2
    assert KeyIndicator({})({"x": 1.0}) == float("-inf")


def test_key_indicator_strict_raises_on_typo():
    with pytest.raises(KeyError, match="accuracy_top-1"):
        KeyIndicator({"resisc.accuracy_top-1": 1.0})({"resisc.accuracy": 9})


def test_key_indicator_lenient_zero_substitutes():
    ki = KeyIndicator({"cls.acc": 1.0, "dior.bbox_mAP": 100.0}, strict=False)
    want = JaxKeyIndicator({"cls.acc": 1.0, "dior.bbox_mAP": 100.0},
                           strict=False)
    assert ki({"cls.acc": 90.0}) == want({"cls.acc": 90.0}) == 45.0


def test_eval_hook_saves_best_where_jax_does(tmp_path):
    """Both packages' eval hooks, interval 2 over 12 steps, fed one metric
    sequence: the log vars gain the same val/ keys, and best_checkpoint is
    written at the same steps with the same meta."""
    seq = [{"r.acc": a, "d.mAP": m} for a, m in
           ((1.0, 0.1), (5.0, 0.05), (2.0, 0.2), (2.0, 0.2), (9.0, 0.0),
            (0.0, 0.3))]
    save_best = {"r.acc": 1, "d.mAP": 100}
    hooks, runners, best = {}, {}, {"jax": [], "port": []}
    for side in ("jax", "port"):
        wd = str(tmp_path / side)
        feed = iter(seq)
        cls = JaxMultiDatasetsEvalHook if side == "jax" else \
            MultiDatasetsEvalHook
        hooks[side] = cls(lambda runner, f=feed: dict(next(f)), interval=2,
                          save_best=save_best, work_dir=wd)
        runners[side] = types.SimpleNamespace(
            params={"w": np.zeros(2, np.float32)}, model=_model(),
            max_iters=12, log_vars={})
    for step in range(1, 13):
        for side in ("jax", "port"):
            r = runners[side]
            r.step, r.log_vars = step, {"loss": 0.0}
            hooks[side].after_train_iter(r)
        jmeta = os.path.join(tmp_path, "jax", "best_checkpoint", "meta.json")
        if os.path.isfile(jmeta):
            with open(jmeta) as f:
                best["jax"].append(json.load(f))
        pbest = os.path.join(tmp_path, "port", "best_checkpoint.pth")
        if os.path.isfile(pbest):
            best["port"].append(load_checkpoint(pbest)["meta"])
        assert sorted(runners["port"].log_vars) == \
            sorted(runners["jax"].log_vars)
    assert [m["iter"] for m in best["port"]] == \
        [m["iter"] for m in best["jax"]]
    assert {m["iter"] for m in best["port"]} == {2, 6, 12}
    for p, j in zip(best["port"], best["jax"]):
        assert p["best_score"] == j["best_score"]
        assert p["metrics"] == j["metrics"]
    ck = load_checkpoint(os.path.join(tmp_path, "port",
                                      "best_checkpoint.pth"))
    assert ck["optimizer"] is None   # weights only
    assert not os.path.exists(os.path.join(tmp_path, "port",
                                           "last_checkpoint"))


# ---------------------------------------------------------------------------
# schedules, initial checkpoint, fp16
# ---------------------------------------------------------------------------

SCHEDULES = {
    "iter_based": dict(runner={"type": "IterBasedRunner", "max_iters": 123},
                       lr_config={"policy": "step", "step": [100]},
                       checkpoint_config={"interval": 50},
                       evaluation={"interval": 25}),
    "epoch_based": dict(runner={"type": "EpochBasedRunner",
                                "max_epochs": 50},
                        lr_config={"policy": "step", "step": [45]},
                        checkpoint_config={"interval": 5},
                        evaluation={"interval": 1}),
    "by_epoch_false": dict(runner={"type": "EpochBasedRunner",
                                   "max_epochs": 2},
                           lr_config={"policy": "poly", "max_iters": 80000},
                           checkpoint_config={"by_epoch": False,
                                              "interval": 20000},
                           evaluation={"by_epoch": False, "interval": 8000}),
    "max_epochs_only": dict(runner={"max_epochs": 3}),
    "none": dict(),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("override", [None, 7])
def test_resolve_schedule_matches_jax(name, override):
    cfg = SCHEDULES[name]
    got = resolve_schedule(cfg, epoch_len=100, max_iters_override=override)
    want = jax_resolve_schedule(Config.fromdict(cfg), epoch_len=100,
                                max_iters_override=override)
    assert got == want
    if name == "epoch_based" and override is None:
        assert got["max_iters"] == 5000
        assert got["lr_config"]["step"] == [4500]
        assert got["checkpoint_config"]["interval"] == 500
        assert got["evaluation"]["interval"] == 100


@pytest.mark.parametrize("path", RUNNER_CONFIGS)
def test_resolve_schedule_of_every_config_matches_jax(path):
    p = os.path.join(ROOT, path)
    got = resolve_schedule(load_cfg(p), epoch_len=1000)
    want = jax_resolve_schedule(
        Config.fromfile(p, import_custom_modules=False), epoch_len=1000)
    assert got == want
    if got["epoch_based"]:
        assert got["max_iters"] == \
            load_cfg(p)["runner"]["max_epochs"] * 1000


def test_resolve_init_checkpoint_precedence(tmp_path):
    """--resume-from > cfg resume_from > --auto-resume; any resume beats
    cfg load_from (weights only)."""
    wd = str(tmp_path / "wd")
    save_checkpoint(wd, 2, _model())
    cfg = dict(resume_from=None, load_from=None)
    assert resolve_init_checkpoint(cfg, None, False, wd) == (None, None)
    assert resolve_init_checkpoint(cfg, "/x", False, wd) == ("/x", None)
    cfg2 = dict(resume_from="/y", load_from="/z")
    assert resolve_init_checkpoint(cfg2, None, False, wd) == ("/y", None)
    cfg3 = dict(load_from="/z")
    r, l = resolve_init_checkpoint(cfg3, None, True, wd)
    assert r.endswith("iter_2.pth") and l is None
    assert resolve_init_checkpoint(cfg3, None, False, wd) == (None, "/z")
    assert resolve_init_checkpoint(cfg3, None, True,
                                   str(tmp_path / "empty")) == (None, "/z")


def test_fp16_cfg_maps_to_bf16_compute():
    cfg = {"model": {}, "fp16": {"loss_scale": 512.0}}
    assert apply_fp16_cfg(cfg) is True
    assert cfg["model"]["compute_dtype"] == "bfloat16"
    cfg = {"model": {"compute_dtype": "float32"},
           "fp16": {"loss_scale": 512.0}}
    assert apply_fp16_cfg(cfg) is False
    assert cfg["model"]["compute_dtype"] == "float32"
    cfg = {"model": {}}
    assert apply_fp16_cfg(cfg) is False and "compute_dtype" not in \
        cfg["model"]


@pytest.mark.parametrize("path", DATA_CONFIGS)
def test_derive_shapes_matches_jax(path):
    p = os.path.join(ROOT, path)
    assert derive_shapes(load_cfg(p)) == jax_derive_shapes(
        Config.fromfile(p, import_custom_modules=False))


def test_rng_streams_are_pure_functions_of_the_seed():
    """A step's generator and a named stream depend on their integers
    alone: the same draws from a fresh pool, others for another step, name
    or seed."""
    def draw(g):
        return torch.rand(4, generator=g).tolist()

    assert draw(step_generator(3, 7)) == draw(step_generator(3, 7))
    assert draw(step_generator(3, 7)) != draw(step_generator(3, 8))
    assert draw(step_generator(3, 7)) != draw(step_generator(4, 7))
    pool = set_random_seed(3)
    assert isinstance(pool, RngPool) and pool.seed == 3
    assert draw(pool.make("cdn", 2)) == draw(RngPool(3).make("cdn", 2))
    assert draw(pool.make("cdn", 2)) != draw(pool.make("drop", 2))
    assert draw(pool.make("cdn")) != draw(pool.make("cdn", 0))
    assert pool.numpy.integers(0, 2 ** 31) == \
        RngPool(3).numpy.integers(0, 2 ** 31)
    assert mix_seed(3, 7) == mix_seed(3, 7) != mix_seed(7, 3)


def test_deterministic_seed_sets_cudnn_flags(monkeypatch):
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    algorithms = torch.are_deterministic_algorithms_enabled()
    # set_random_seed sets the variable unless it is set: undone after
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    try:
        torch.backends.cudnn.benchmark = True
        set_random_seed(5, deterministic=True)
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        first = np.random.randint(1 << 30)
        np.random.seed(5)
        assert first == np.random.randint(1 << 30)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        torch.use_deterministic_algorithms(algorithms)


def test_profile_cfg_writes_a_trace(tmp_path):
    """profile_cfg traces steps [start, end) with torch.profiler and
    writes a Chrome trace to logdir."""
    def step(batch, generator):
        return {"loss": torch.ones(3).sum()}

    logdir = str(tmp_path / "prof")
    runner = IterBasedRunner({"cls": step}, max_iters=5, prefetch=0,
                             profile_cfg=dict(start=1, end=3,
                                              logdir=logdir))
    runner.run(_Loader(10))
    assert os.listdir(logdir) == ["trace_iter3.json"]
    with open(os.path.join(logdir, "trace_iter3.json")) as f:
        assert json.load(f)["traceEvents"]
