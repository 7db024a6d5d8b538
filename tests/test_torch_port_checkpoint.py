"""The port's checkpoints (rscotr_tpu_torch/engine/checkpoint.py): mm-format
``.pth`` files that round-trip bit for bit, the JAX package's path aliases,
the ``last_checkpoint`` pointer, the refusal of orbax directories, and the
way between the packages in both directions through the JAX package's
``tools/convert_checkpoint.py``:

(a) a JAX orbax checkpoint of the tiny model -> ``--to-torch`` -> the
    port's ``tools/test.py --device cpu --max-batches 2`` against JAX's
    ``tools/test.py`` on the orbax directory (the runbook of
    tests/test_parity_runbook.py): raw results within the slice
    tolerances, each CLI's metrics those of its own raw results, and the
    two equal over what the decision margins make clear
    (tests/helpers/eval_parity.py);
(b) the port's ``save_checkpoint`` -> forward conversion -> JAX params
    equal, bit for bit, to the ones the port saved.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.apis import make_step_config
from rscotr_tpu_torch.engine import (build_optimizer, find_latest_checkpoint,
                                     load_checkpoint, make_infer_steps,
                                     make_train_step, resolve_checkpoint,
                                     save_checkpoint)
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.eval_parity import (check_cls, check_det,  # noqa: E402
                                 metrics_match_where_clear)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
DEPTHS = ["--depths", "1", "1", "2", "1"]


def _load_tool(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(seed):
    return build_model(load_cfg(TINY)["model"], device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _optimizer(cfg, model):
    return build_optimizer(cfg["optimizer"], model.named_parameters(),
                           lr_config=cfg["lr_config"],
                           grad_clip=cfg["optimizer_config"]["grad_clip"])


@pytest.fixture(scope="module")
def trained():
    """The tiny model and its optimizer after one cls step."""
    cfg = load_cfg(TINY)
    model = _model(0)
    opt = _optimizer(cfg, model)
    rng = np.random.default_rng(0)
    step = make_train_step(model, opt, "cls", make_step_config(cfg))
    step(dict(img=rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
              gt_label=np.array([3, 7], np.int32)),
         torch.Generator().manual_seed(0))
    model.eval()
    return cfg, model, opt


def test_round_trip_is_bit_equal(trained, tmp_path):
    cfg, model, opt = trained
    meta = {"CLASSES": {"resisc": ("a", "b")}, "note": np.float32(0.5)}
    path = save_checkpoint(str(tmp_path), 3, model, opt, meta=meta)
    assert path == str(tmp_path / "iter_3.pth")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(raw) == ["meta", "optimizer", "state_dict"]
    assert raw["meta"] == {"CLASSES": {"resisc": ["a", "b"]}, "note": "0.5",
                           "iter": 3}
    fresh = _model(1)
    fresh_opt = _optimizer(cfg, fresh)
    ck = load_checkpoint(str(tmp_path / "latest.pth"), model=fresh,
                         optimizer=fresh_opt)
    assert ck["path"] == path and ck["meta"]["iter"] == 3
    want = model.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert fresh_opt.step == opt.step == 1 and fresh_opt.count == opt.count
    for n in opt.params:
        assert torch.equal(fresh_opt.mu[n], opt.mu[n])
        assert torch.equal(fresh_opt.nu[n], opt.nu[n])
    img = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    assert torch.equal(make_infer_steps(fresh)["cls"](img),
                       make_infer_steps(model)["cls"](img))


def test_load_is_strict_and_unwraps(trained, tmp_path):
    _, model, _ = trained
    sd = model.state_dict()
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}},
               str(tmp_path / "ddp.pth"))
    fresh = _model(1)
    load_checkpoint(str(tmp_path / "ddp.pth"), model=fresh)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in sd.items())
    torch.save({k: v for k, v in sd.items() if "cls_head" not in k},
               str(tmp_path / "part.pth"))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_checkpoint(str(tmp_path / "part.pth"), model=_model(1))
    with pytest.raises(KeyError, match="no optimizer state"):
        load_checkpoint(str(tmp_path / "part.pth"), optimizer=object())


def test_pointer_moves_with_regular_saves_only(trained, tmp_path):
    _, model, _ = trained
    wd = str(tmp_path)
    assert find_latest_checkpoint(wd) is None
    p1 = save_checkpoint(wd, 1, model)
    p2 = save_checkpoint(wd, 2, model)
    pointer = tmp_path / "last_checkpoint"
    assert pointer.read_text() == p2 == find_latest_checkpoint(wd)
    best = save_checkpoint(wd, 5, model, name="best_checkpoint")
    assert best == str(tmp_path / "best_checkpoint.pth")
    assert pointer.read_text() == p2
    assert torch.load(best, weights_only=True)["meta"]["iter"] == 5
    # a pointer naming a file that is gone: the largest iter_N.pth
    save_checkpoint(wd, 10, model)
    os.remove(str(tmp_path / "iter_10.pth"))
    assert find_latest_checkpoint(wd) == p2
    assert not any(f.endswith(".tmp") for f in os.listdir(wd))
    assert p1 != p2


@pytest.mark.parametrize("alias,want", [
    ("", "iter_2.pth"), ("latest", "iter_2.pth"),
    ("latest.pth", "iter_2.pth"), ("best.pth", "best_checkpoint.pth"),
    ("best_bbox_mAP", "best_checkpoint.pth"), ("iter_1", "iter_1.pth"),
    ("iter_1.pth", "iter_1.pth"), ("best_checkpoint", "best_checkpoint.pth"),
])
def test_resolve_checkpoint_aliases(trained, tmp_path, alias, want):
    _, model, _ = trained
    wd = str(tmp_path)
    save_checkpoint(wd, 1, model)
    save_checkpoint(wd, 2, model)
    save_checkpoint(wd, 2, model, name="best_checkpoint")
    path = os.path.join(wd, alias) if alias else wd
    assert resolve_checkpoint(path) == os.path.join(wd, want)


def test_missing_and_orbax_checkpoints_are_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(str(tmp_path / "iter_7.pth"))
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(str(tmp_path / "latest.pth"))
    # a JAX work_dir: orbax iter_N directories and a pointer to one
    orbax = tmp_path / "jax_wd" / "iter_4"
    orbax.mkdir(parents=True)
    (orbax / "meta.json").write_text("{}")
    (tmp_path / "jax_wd" / "last_checkpoint").write_text(str(orbax))
    for path in (orbax, orbax.parent, orbax.parent / "iter_4.pth"):
        with pytest.raises(ValueError, match="--to-torch"):
            load_checkpoint(str(path))


# ---------------------------------------------------------------------------
# interop with the JAX package
# ---------------------------------------------------------------------------

def _jit_init_model_params(model, cfg, seed=0):
    """``rscotr_tpu.apis.init_model_params`` with ``model.init`` under
    ``jax.jit``: the same inputs and the same tree, made in seconds where
    the eager init takes over a minute on the CPU. The conversion tool
    takes it in its place: the tensors it converts overwrite every leaf."""
    import jax
    import jax.numpy as jnp

    from rscotr_tpu.apis import derive_shapes, make_step_config
    from rscotr_tpu.models.heads.cdn import cdn_self_attn_mask
    shapes = derive_shapes(cfg)
    kw = {"cls_img": jnp.zeros((1,) + shapes["cls"][1:]),
          "det_img": jnp.zeros((1,) + shapes["det"][1:]),
          "det_img_hw": jnp.asarray([list(shapes["det"][1:3])], jnp.int32),
          "seg_img": jnp.zeros((1,) + shapes["seg"][1:])}
    cdn = make_step_config(cfg).cdn
    kw.update(dn_label_query=jnp.zeros((1, cdn.pad_size,
                                        model.bbox_head.embed_dims)),
              dn_bbox_query=jnp.zeros((1, cdn.pad_size, 4)),
              attn_mask=jnp.asarray(cdn_self_attn_mask(cdn)))
    return jax.jit(lambda k: model.init(k, **kw))(jax.random.key(seed))


@pytest.fixture(scope="module")
def orbax_ckpt(tmp_path_factory):
    """A JAX orbax checkpoint of the tiny model (init seed 3, as
    tests/test_parity_runbook.py), its JAX params, and its conversion."""
    from rscotr_tpu.config import Config
    from rscotr_tpu.engine import save_checkpoint as jax_save_checkpoint
    from rscotr_tpu.models import build_model as jax_build_model
    wd = tmp_path_factory.mktemp("orbax")
    jcfg = Config.fromfile(TINY)
    jm = jax_build_model(jcfg.model)
    params = _jit_init_model_params(jm, jcfg, seed=3)
    path = jax_save_checkpoint(str(wd), step=0, params=params, name="native",
                               meta={"CLASSES": {"resisc": ["x"]}})
    pth = str(wd / "converted.pth")
    conv = _load_tool("tools/convert_checkpoint.py", "convert_ckpt_port")
    conv.main([TINY, path, pth, "--to-torch"] + DEPTHS)
    return jcfg, jm, params, path, pth


def test_jax_checkpoint_loads_strict_in_the_port(orbax_ckpt):
    *_, params, _, pth = orbax_ckpt
    model = _model(1)
    ck = load_checkpoint(pth, model=model)
    assert ck["meta"]["CLASSES"] == {"resisc": ["x"]}
    want = state_dict_from_jax(
        {k: v for k, v in params["params"].items()})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_port_cli_matches_jax_cli_on_converted_checkpoint(orbax_ckpt,
                                                          tmp_path):
    import jax
    import jax.numpy as jnp

    from rscotr_tpu.apis import derive_img_norm as jax_derive_img_norm
    from rscotr_tpu.data import build_dataloaders as jax_build_dataloaders
    from rscotr_tpu.data import build_datasets as jax_build_datasets
    from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
    from rscotr_tpu.engine.test import _resize_bilinear_np
    from rscotr_tpu.engine.test import evaluate_results as jax_evaluate
    from rscotr_tpu.engine.test import single_device_test as jax_sdt
    from rscotr_tpu_torch.data import build_datasets
    from rscotr_tpu_torch.engine import evaluate_results
    from rscotr_tpu_torch.tools import test as port_cli
    jcfg, jm, params, orbax, pth = orbax_ckpt
    out = {}
    for who in ("port", "jax"):
        args = ["--max-batches", "2", "--eval-out",
                str(tmp_path / f"{who}.json"), "--out",
                str(tmp_path / f"{who}.pkl")]
        if who == "port":
            got = port_cli.main([TINY, pth, "--device", "cpu"] + args)
        else:
            with jax.default_matmul_precision("highest"):
                _load_tool("tools/test.py", "jax_test_cli").main(
                    [TINY, orbax] + args)
        metrics = json.load(open(tmp_path / f"{who}.json"))
        raw = pickle.load(open(tmp_path / f"{who}.pkl", "rb"))
        out[who] = metrics, raw
    assert got == out["port"][0]
    assert sorted(out["port"][0]) == sorted(out["jax"][0])

    # each CLI's metrics are those of its own raw results
    cfg = load_cfg(TINY)
    ds = build_datasets(cfg["data"], split="val")
    jds = jax_build_datasets(jcfg.data, split="val")
    kw = {t: dict(cfg["evaluation"].get(t, {})) for t in ("cls", "det",
                                                          "seg")}
    assert evaluate_results(ds, out["port"][1], kw) == out["port"][0]
    assert jax_evaluate(jds, out["jax"][1], kw) == out["jax"][0]

    # JAX's det at max_per_img + 1 and seg logits on the same two batches:
    # the margins of the decisions the metrics take
    k = cfg["model"]["test_cfg"]["det"]["max_per_img"]
    stc = cfg["model"]["test_cfg"]["seg"]
    jloaders = jax_build_dataloaders(jds, jcfg.data, train=False)
    jinfer = jax_make_infer_steps(jm, max_per_img=k + 1,
                                  img_norm=jax_derive_img_norm(jcfg),
                                  seg_test_cfg=stc)
    with jax.default_matmul_precision("highest"):
        more = jax_sdt({"det": jinfer["det"]}, params,
                       {"dior": jloaders["dior"]}, max_batches=2)
        logits = []
        for bi, batch in enumerate(jloaders["potsdam"]):
            if bi == 2:
                break
            lg = np.asarray(jinfer["seg_logits"](params,
                                                 jnp.asarray(batch["img"])))
            logits += [_resize_bilinear_np(lg[i, :h, :w], ori) for i, (
                (h, w), ori) in enumerate(zip(batch["img_hw"],
                                              batch["ori_hw"]))]
    port_raw, jax_raw = out["port"][1], out["jax"][1]
    check_cls(port_raw["resisc"], jax_raw["resisc"])
    check_det(jax_raw["dior"], more["dior"])
    check_det(port_raw["dior"], more["dior"])
    cleared = metrics_match_where_clear(ds, jds, port_raw, jax_raw, more,
                                        {"potsdam": logits})
    print("cleared by the margins:", cleared)


def test_port_checkpoint_converts_forward_bit_equal(trained, tmp_path,
                                                   monkeypatch):
    """The port's save -> JAX forward conversion -> the same weights."""
    import rscotr_tpu.apis
    from rscotr_tpu.engine import load_checkpoint as jax_load_checkpoint
    _, model, _ = trained
    pth = save_checkpoint(str(tmp_path / "wd"), 1, model,
                          meta={"CLASSES": {"resisc": ["a"]}})
    monkeypatch.setattr(rscotr_tpu.apis, "init_model_params",
                        _jit_init_model_params)
    conv = _load_tool("tools/convert_checkpoint.py", "convert_ckpt_fwd")
    conv.main([TINY, pth, str(tmp_path / "out")] + DEPTHS)
    ck = jax_load_checkpoint(str(tmp_path / "out" / "converted"))
    tree = ck["params"]["params"]
    got = state_dict_from_jax(tree)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:10]


# ---------------------------------------------------------------------------
# the port's tools/test.py on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ckpt(trained, tmp_path_factory):
    _, model, _ = trained
    wd = tmp_path_factory.mktemp("cli")
    save_checkpoint(str(wd), 1, model)
    return str(wd / "latest.pth")


def _cli(argv):
    from rscotr_tpu_torch.tools import test as port_cli
    return port_cli.main(argv)


def test_cli_runs_on_the_card_unless_asked(port_ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli([TINY, port_ckpt, "--max-batches", "1"])


@pytest.mark.parametrize("flag", [["--launcher", "pytorch"], ["--show"],
                                  ["--show-dir", "painted"]])
def test_cli_refuses_what_waits_for_m7(port_ckpt, flag, tmp_path,
                                       monkeypatch):
    """``--launcher``: ``jax`` (a TPU pod's launcher) is refused with the
    port's command line, ``slurm`` outside slurm says which variables are
    missing (``pytorch`` under ``torch.distributed.run`` is driven in
    tests/test_torch_port_dist_tools.py); ``--show`` (into
    WORK_DIR/painted) and ``--show-dir`` paint each evaluated image."""
    if flag[0] == "--launcher":
        with pytest.raises(ValueError, match="torch.distributed.run"):
            _cli([TINY, port_ckpt, "--device", "cpu", "--launcher", "jax"])
        monkeypatch.delenv("SLURM_PROCID", raising=False)
        with pytest.raises(RuntimeError, match="SLURM_PROCID"):
            _cli([TINY, port_ckpt, "--device", "cpu", "--launcher",
                  "slurm"])
        return
    painted = tmp_path / "painted"
    _cli([TINY, port_ckpt, "--device", "cpu", "--tasks", "cls",
          "--max-batches", "1", "--work-dir", str(tmp_path)]
         + [str(painted) if f == "painted" else f for f in flag])
    files = set(os.listdir(painted / "resisc"))
    assert files and files == {f"{i}.png" for i in range(len(files))}


def test_cli_tasks_eval_and_cached_outputs(port_ckpt, tmp_path):
    """``--tasks`` keeps its datasets; ``--eval`` routes each metric name
    to its task (one outside ``--tasks`` is ignored); ``--out`` then
    ``--test_outputs`` gives the same metrics without a model;
    ``--cfg-options`` reaches the loaders."""
    base = [TINY, port_ckpt, "--device", "cpu", "--max-batches", "1"]
    raw = str(tmp_path / "raw.pkl")
    got = _cli(base + ["--tasks", "cls", "seg", "--eval", "mIoU", "bbox",
                       "--out", raw, "--work-dir", str(tmp_path)])
    assert {k.split(".")[0] for k in got} == {"resisc", "potsdam"}
    assert "potsdam.mIoU" in got and "potsdam.mFscore" not in got
    assert json.load(open(tmp_path / "eval_metrics.json")) == got
    again = _cli([TINY, "no-such.pth", "--tasks", "cls", "seg", "--eval",
                  "mIoU", "--test_outputs", raw, "--eval-out",
                  str(tmp_path / "again.json")])
    assert again == got
    wide = _cli(base + ["--tasks", "cls", "--cfg-options",
                        "data.resisc.data.test_samples_per_gpu=3",
                        "--out", raw, "--eval-out",
                        str(tmp_path / "wide.json")])
    assert len(pickle.load(open(raw, "rb"))["resisc"]) == 3
    assert sorted(wide) == ["resisc.accuracy_top-1", "resisc.accuracy_top-5"]


def test_cli_format_only(port_ckpt, tmp_path):
    out = _cli([TINY, port_ckpt, "--device", "cpu", "--max-batches", "1",
                "--format-only", "--work-dir", str(tmp_path)])
    assert out is None
    assert {"cls_results.pkl", "det_results.pkl", "seg_results.pkl"} <= \
        set(os.listdir(tmp_path))
