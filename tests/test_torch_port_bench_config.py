"""The port's root harness (``rscotr_tpu_torch/bench.py``, ROADMAP M11) and
its config path (``rscotr_tpu_torch/config``, ``version.py``, M13) against
the JAX package's, on the CPU.

The root ``bench.py`` is loaded by its path, as ``tests/test_tools.py``
loads it: it imports ``jax`` only inside ``main``, which is never run here
(it would train 160 flagship iterations). Its line's keys are read from
its source with ``ast``: the ``out`` dict and the keys its two branches add.
The port's bench runs in this process on the tiny config (its module's
config paths and input sides set to the tiny ones), three iterations,
``--device cpu``: it must print one line with exactly those keys.
``steady_state_mix`` is the root's, copied: equal on
``TestBenchSteadyState``'s records and on the records of the port's own
training run.
"""

import ast
import glob
import importlib.util
import json
import os

import pytest

import rscotr_tpu_torch.config as port_config
from rscotr_tpu_torch import bench
from rscotr_tpu_torch.utils.config import load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "configs/multi/MTL_tiny_synthetic.py"
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))
TINY_ARGV = ["--device", "cpu"]


def tiny(mp):
    """The harness on the tiny config at small inputs (the test's cut)."""
    mp.setattr(bench, "TRAIN_CFG", TINY)
    mp.setattr(bench, "INFER_CFG", TINY)
    mp.setattr(bench, "SIZES", {"cls": 32, "det": 64, "seg": 32})


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def root_line_keys():
    """(keys of the root's line after a training run, after a failed one):
    its ``out = {...}`` literal, then the ``out["k"] = ...`` of each branch
    of the ``if train_img_s is not None`` that follows."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    base = set()
    branches = None
    for node in main.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["out"]:
            base = {k.value for k in node.value.keys}
        if isinstance(node, ast.If) and base and branches is None:
            branches = [{t.slice.value for stmt in body
                         if isinstance(stmt, ast.Assign)
                         for t in stmt.targets
                         if isinstance(t, ast.Subscript)}
                        for body in (node.body, node.orelse)]
    assert base and branches, "bench.py's out dict not found"
    return base | branches[0], base | branches[1]


# the records of TestBenchSteadyState (tests/test_tools.py)
STEADY_RECORDS = [
    [{"step": 1, f"{t}.d.loss": 1.0, "time": x}
     for t, times in [("cls", [0.17, 0.18, 0.17]),
                      ("det", [120.0, 0.32, 0.32, 0.32]),
                      ("seg", [28.0, 0.15, 0.15])] for x in times],
    [{"step": 1, "cls.d.loss": 1.0, "time": 0.1}],
    [{"step": 1, f"{t}.d.loss": 1.0, "time": 60.0}
     for t in ("cls", "det", "seg")],
]


@pytest.mark.parametrize("case", range(len(STEADY_RECORDS)))
def test_steady_state_mix_equals_the_roots(root_bench, case):
    recs = STEADY_RECORDS[case]
    assert bench.steady_state_mix(recs) == root_bench.steady_state_mix(recs)


@pytest.fixture(scope="module")
def tiny_bench_run():
    """The port's bench on the tiny config on the CPU (3 co-training
    iterations, one a task), in this process: its stdout, stderr, returned
    line and the metrics records its ``steady_state_mix`` was given."""
    seen = []
    real = bench.steady_state_mix

    def spy(recs, *a, **kw):
        seen.append([dict(r) for r in recs])
        return real(recs, *a, **kw)

    mp = pytest.MonkeyPatch()
    tiny(mp)
    mp.setattr(bench, "steady_state_mix", spy)
    mp.setenv("RSCOTR_BENCH_TRAIN_ITERS", "3")
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            line = bench.main(TINY_ARGV)
    finally:
        mp.undo()
    return out.getvalue(), err.getvalue(), line, seen


def test_bench_prints_one_line_with_the_roots_keys(tiny_bench_run):
    stdout, stderr, line, seen = tiny_bench_run
    lines = stdout.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    trained, _ = root_line_keys()
    assert set(line) == trained
    assert "train_bench_error" not in line and line["device"] == "cpu"
    assert line["mfu"] is None            # no peak off the H100
    assert line["value"] > 0 and line["infer_img_s"] > 0
    # both from the run's img/s before rounding, as at the root (the
    # rounded value / 31 rounds differently where a third decimal of
    # vs_baseline sits on the rounding's edge)
    img_s = (bench.CLS_BS + bench.DET_BS + bench.SEG_BS) / \
        bench.steady_state_mix(seen[0])[0]
    assert line["value"] == round(img_s, 2)
    assert line["vs_baseline"] == round(img_s / 31.0, 3)
    # 19 images over the three tasks' ms
    ms = sum(line[f"{t}_ms"] for t in ("cls", "det", "seg"))
    assert abs(line["infer_img_s"] - 19e3 / ms) <= 0.02 * line["infer_img_s"]
    assert "launches per inference call" in stderr


def test_steady_state_mix_on_a_port_run(root_bench, tiny_bench_run):
    """The records of the port's training run, one per step (the tiny
    config dispatches one step at a time), cover the three tasks."""
    *_, seen = tiny_bench_run
    assert len(seen) == 1
    recs = seen[0]
    assert {next(k.split(".")[0] for k in r if k.endswith(".loss"))
            for r in recs} == {"cls", "det", "seg"}
    assert bench.steady_state_mix(recs) == root_bench.steady_state_mix(recs)


def test_a_failed_training_half_still_gives_the_line(monkeypatch, capsys):
    """As at the root: ``train_bench_error`` and the inference headline."""
    def broken(*a, **kw):
        raise RuntimeError("no card")

    tiny(monkeypatch)
    monkeypatch.setattr(bench, "train_headline", broken)
    line = bench.main(TINY_ARGV)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    _, failed = root_line_keys()
    assert set(line) == failed
    assert line["train_bench_error"] == "RuntimeError: no card"
    assert line["value"] == line["infer_img_s"]
    assert line["metric"].startswith("img/s/chip MTL inference")


# ---------------------------------------------------------------------------
# the config path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_config_fromfile_equals_jax_and_load_cfg(path):
    from rscotr_tpu.config import Config as JaxConfig
    p = os.path.join(ROOT, path)
    got = port_config.Config.fromfile(p)
    want = JaxConfig.fromfile(p).to_dict()
    assert got.to_dict() == want == load_cfg(p)
    assert got.filename == os.path.abspath(p)


def test_config_surface_equals_jax():
    """Attribute access, the mapping methods, ``copy``,
    ``merge_from_dict``, ``dump`` and ``fromdict``, on the flagship."""
    from rscotr_tpu.config import Config as JaxConfig
    p = os.path.join(ROOT, "configs/multi/MTL_synthetic_flagship.py")
    got, want = port_config.Config.fromfile(p), JaxConfig.fromfile(p)
    assert isinstance(got.model, port_config.ConfigDict)
    assert got.model.backbone.type == want.model.backbone.type == \
        "SwinTransformer"
    assert got["runner"]["max_iters"] == got.runner.max_iters == 60
    assert list(got) == list(want) and len(got) == len(want)
    assert "model" in got and got.get("nothing", 3) == 3
    with pytest.raises(AttributeError):
        got.model.nothing
    opts = {"model.backbone.depths.1": 4, "optimizer.lr": 1e-3,
            "runner.max_iters": 7}
    mine, theirs = got.copy(), want.copy()
    mine.merge_from_dict(opts)
    theirs.merge_from_dict(opts)
    assert mine.to_dict() == theirs.to_dict() != got.to_dict()
    assert mine.dump() == theirs.dump()
    assert port_config.Config.fromdict(mine.to_dict()).to_dict() == \
        mine.to_dict()
    with pytest.raises(KeyError, match="reserved"):
        port_config.Config({"filename": 1})


def test_registries_hold_jax_names():
    """Each of the ten registries holds the JAX registry's names once both
    packages' models, data and hooks are imported (the registry module's
    docstring names none missing); the port's classes under them."""
    import rscotr_tpu.config as jax_config
    import rscotr_tpu.data  # noqa: F401
    import rscotr_tpu.engine  # noqa: F401
    import rscotr_tpu.models  # noqa: F401
    import rscotr_tpu.models.dino  # noqa: F401
    import rscotr_tpu.models.rscotr_seg  # noqa: F401
    import rscotr_tpu_torch.data  # noqa: F401
    import rscotr_tpu_torch.engine.hooks  # noqa: F401
    from rscotr_tpu_torch.models import dino, mtl, rscotr_seg
    from rscotr_tpu_torch.utils import registry
    names = ("MODELS", "BACKBONES", "NECKS", "HEADS", "TRANSFORMERS",
             "DATASETS", "PIPELINES", "STRATEGIES", "HOOKS",
             "OPTIMIZER_BUILDERS")
    assert set(names) <= set(port_config.__all__)
    def own(reg, package):
        # what the package itself registers (tests register helpers too)
        return sorted(k for k in reg.keys()
                      if reg.get(k).__module__.startswith(package + "."))

    for name in names:
        ours, theirs = getattr(port_config, name), getattr(jax_config, name)
        assert own(ours, "rscotr_tpu_torch") == own(theirs, "rscotr_tpu"), \
            name
    for name in ("DATASETS", "PIPELINES", "HOOKS", "STRATEGIES"):
        assert getattr(port_config, name) is getattr(registry, name)
    assert port_config.MODELS.get("MTL") is mtl.MTL
    assert port_config.MODELS.get("DINO") is dino.DINO
    assert port_config.MODELS.get("RSCoTrSeg") is rscotr_seg.RSCoTrSeg
    # a child's names are found from its parent, as JAX's
    assert port_config.MODELS.get("SwinTransformer") is \
        port_config.BACKBONES.get("SwinTransformer")


def test_version_and_dict_action():
    import argparse

    from rscotr_tpu.version import __version__ as jax_version
    from rscotr_tpu_torch.version import __version__
    assert __version__ == jax_version == "0.1.0"
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg-options", nargs="+",
                    action=port_config.DictAction.action())
    args = ap.parse_args(["--cfg-options", "a.b=1", "c=x,y"])
    assert args.cfg_options == {"a.b": 1, "c": ["x", "y"]}
