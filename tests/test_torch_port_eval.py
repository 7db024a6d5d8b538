"""The evaluation slice end to end: the tiny config's val sets through the
port's ``single_device_test`` against the JAX package's, with the same
weights (carried across by ``state_dict_from_jax``), float32, JAX under
highest matmul precision; then ``evaluate_results``, ``make_val_step`` and
``make_eval_fn``.

The val sets are the tiny config's (cls 16 x 128^2, det 8 x 256^2, seg 8 x
128^2, each 4 a batch) and a Potsdam-format folder of two 100 x 150 tiles
written here, whose keep-ratio resize to 85 x 128 (padded to 128^2) takes
the seg logits path: crop to the image, bilinear resize to 100 x 150, then
the argmax. Its two tiles fill half a batch, so ``_pad_batch`` pads it.

Raw results are held within the slice tolerances and the metrics of the
two packages asserted equal only where every decision margin is clear
(tests/helpers/eval_parity.py). JAX runs its det step at ``max_per_img +
1`` so the score of the first detection cut is known; its results at
``max_per_img`` are those minus each image's lowest-scored detection.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from rscotr_tpu.apis import derive_img_norm as jax_derive_img_norm
from rscotr_tpu.apis import make_step_config as jax_make_step_config
from rscotr_tpu.config import Config
from rscotr_tpu.data import build_dataloaders as jax_build_dataloaders
from rscotr_tpu.data import build_datasets as jax_build_datasets
from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.engine.test import _resize_bilinear_np as jax_resize_np
from rscotr_tpu.engine.test import evaluate_results as jax_evaluate_results
from rscotr_tpu.engine.test import single_device_test as jax_sdt
from rscotr_tpu.engine.train_step import make_val_step as jax_make_val_step
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch.apis import (derive_img_norm, make_eval_fn,
                                   make_step_config)
from rscotr_tpu_torch.data import build_dataloaders, build_datasets
from rscotr_tpu_torch.engine import (evaluate_results, make_infer_steps,
                                     make_val_step, single_device_test)
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.eval_parity import (SEG_TOL, check_cls, check_det,  # noqa: E402
                                 check_seg, metrics_match_where_clear,
                                 same_metrics)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
HIGHEST = jax.default_matmul_precision("highest")
TILE_HW = (100, 150)


def _write_tiles(root):
    rng = np.random.default_rng(11)
    for d in ("img", "ann"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, TILE_HW + (3,)).astype(
            np.uint8)).save(os.path.join(root, "img", f"tile_{i}.png"))
        Image.fromarray(rng.integers(0, 7, TILE_HW).astype(np.uint8)).save(
            os.path.join(root, "ann", f"tile_{i}.png"))


def _patch_data(data, tile_root):
    """Both packages' ``cfg.data``: 4 images a batch, and the tile set."""
    for entry in data.values():
        entry["data"]["test_samples_per_gpu"] = 4
    data["tiles"] = dict(
        task="seg",
        data=dict(test_samples_per_gpu=4, val=dict(
            type="PotsdamDataset", data_root=tile_root, img_dir="img",
            ann_dir="ann", pipeline=[
                dict(type="LoadImageFromFile"),
                dict(type="Resize", img_scale=(128, 128), keep_ratio=True),
                dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375])])),
        loader=dict(seg_size=128, seg_pad_val=5))


def _counting(steps):
    """The steps, each counting its calls in ``calls``."""
    calls = {k: 0 for k in steps}

    def wrap(k, f):
        def g(*a):
            calls[k] += 1
            return f(*a)
        return g
    return {k: wrap(k, f) for k, f in steps.items()}, calls


def _cut(per_class):
    """JAX's results at k + 1 -> at k: drop the lowest-scored detection."""
    scores = [(a[:, 4].min(), c) for c, a in enumerate(per_class) if len(a)]
    _, c = min(scores)
    a = per_class[c]
    out = list(per_class)
    out[c] = np.delete(a, int(np.argmin(a[:, 4])), axis=0)
    return out


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tile_root = str(tmp_path_factory.mktemp("tiles"))
    _write_tiles(tile_root)
    jcfg = Config.fromfile(TINY)
    cfg = load_cfg(TINY)
    _patch_data(jcfg.data, tile_root)
    _patch_data(cfg["data"], tile_root)

    jm = jax_build_model(jcfg.model)
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params["params"])
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    k = cfg["model"]["test_cfg"]["det"]["max_per_img"]
    stc = cfg["model"]["test_cfg"]["seg"]

    jds = jax_build_datasets(jcfg.data, split="val")
    jloaders = jax_build_dataloaders(jds, jcfg.data, train=False)
    jinfer = jax_make_infer_steps(jm, max_per_img=k + 1,
                                  img_norm=jax_derive_img_norm(jcfg),
                                  seg_test_cfg=stc)
    with HIGHEST:
        jres = jax_sdt(jinfer, params, jloaders)
    jres_k = dict(jres, dior=[_cut(r) for r in jres["dior"]])

    ds = build_datasets(cfg["data"], split="val")
    loaders = build_dataloaders(ds, cfg["data"], train=False)
    infer, calls = _counting(make_infer_steps(
        model, max_per_img=k, img_norm=derive_img_norm(cfg),
        seg_test_cfg=stc))
    stats = {}
    res = single_device_test(infer, loaders, stats=stats)

    # the seg logits of both packages on every seg batch, and JAX's cropped
    # and resized to each image's original size (its margins)
    seg_logits = {}
    for name in ("potsdam", "tiles"):
        got, want, per_image = [], [], []
        for batch in loaders[name]:
            got.append(infer["seg_logits"](batch["img"]).numpy())
            with HIGHEST:
                lg = np.asarray(jinfer["seg_logits"](
                    params, jnp.asarray(batch["img"])))
            want.append(lg)
            for i, (hw, ori) in enumerate(zip(batch["img_hw"],
                                              batch["ori_hw"])):
                per_image.append(jax_resize_np(lg[i, :hw[0], :hw[1]], ori))
        seg_logits[name] = (got, want, per_image)
    return dict(cfg=cfg, jcfg=jcfg, jm=jm, params=params, model=model,
                k=k, ds=ds, jds=jds, loaders=loaders, res=res, jres=jres,
                jres_k=jres_k, calls=calls, stats=stats,
                seg_logits=seg_logits)


def test_datasets_and_batches(evaluated):
    e = evaluated
    assert {n: len(r) for n, r in e["res"].items()} == \
        {n: len(r) for n, r in e["jres"].items()} == \
        {"resisc": 16, "dior": 8, "potsdam": 8, "tiles": 2}
    assert {n: len(s["infer_s"]) for n, s in e["stats"].items()} == \
        {"resisc": 4, "dior": 2, "potsdam": 2, "tiles": 1}
    # potsdam's uniform tiles take the on-device argmax (2 seg calls); the
    # resized tiles the logits path (1 call in single_device_test; the
    # fixture's margin pass then calls it once per seg batch: 2 + 1)
    assert e["calls"]["cls"] == 4 and e["calls"]["det"] == 2
    assert e["calls"]["seg"] == 2
    assert e["calls"]["seg_logits"] == 1 + 2 + 1
    assert e["res"]["tiles"][0].shape == TILE_HW
    assert e["res"]["potsdam"][0].shape == (128, 128)


def test_cls_results_match_jax(evaluated):
    check_cls(evaluated["res"]["resisc"], evaluated["jres"]["resisc"])


def test_det_results_match_jax(evaluated):
    e = evaluated
    got = e["res"]["dior"]
    assert all(len(r) == 20 and sum(len(a) for a in r) == e["k"]
               for r in got)
    assert all(a.dtype == np.float32 and a.shape[1:] == (5,)
               for r in got for a in r)
    check_det(got, e["jres"]["dior"])


@pytest.mark.parametrize("name", ["potsdam", "tiles"])
def test_seg_results_match_jax(evaluated, name):
    got, want, per_image = evaluated["seg_logits"][name]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=SEG_TOL)
    res, jres = evaluated["res"][name], evaluated["jres"][name]
    assert all(r.dtype == np.int32 for r in res)
    check_seg(res, jres, per_image)


EVAL_KWARGS = {
    "config": None,
    "classwise": dict(cls=dict(topk=(1, 5)),
                      det=dict(iou_thrs=[0.5, 0.75], classwise=True),
                      seg=dict(metric=["mIoU", "mDice", "mFscore"],
                               classwise=True)),
}


@pytest.mark.parametrize("which", sorted(EVAL_KWARGS))
def test_evaluate_results_matches_jax(evaluated, which):
    """Both packages' ``evaluate_results`` on the port's raw results."""
    e = evaluated
    kw = EVAL_KWARGS[which] or {
        t: dict(e["cfg"]["evaluation"].get(t, {}))
        for t in ("cls", "det", "seg")}
    got = evaluate_results(e["ds"], e["res"], kw)
    want = jax_evaluate_results(e["jds"], e["res"], kw)
    same_metrics(got, want)
    assert {k.split(".")[0] for k in got} == {"resisc", "dior", "potsdam",
                                              "tiles"}
    with pytest.raises(ValueError, match="no inference results"):
        evaluate_results(e["ds"], dict(e["res"], tiles=[]), kw)
    assert not any(k.startswith("tiles.") for k in evaluate_results(
        e["ds"], dict(e["res"], tiles=[]), kw, allow_empty=True))


def test_end_to_end_metrics_match_jax(evaluated):
    """Each package's metrics from its own results, over what every
    decision margin makes clear (``metrics_match_where_clear``)."""
    e = evaluated
    cleared = metrics_match_where_clear(
        e["ds"], e["jds"], e["res"], e["jres_k"], e["jres"],
        {n: e["seg_logits"][n][2] for n in ("potsdam", "tiles")})
    print("cleared by the margins:", cleared)


@pytest.mark.parametrize("task,name", [("cls", "resisc"), ("det", "dior"),
                                       ("seg", "potsdam")])
def test_val_step_matches_jax(evaluated, task, name):
    """``make_val_step`` on the first val batch, the det step with the same
    CDN noise in both (the ``dn_noise_*`` entries): every weighted log var
    within the train slice's tolerances."""
    e = evaluated
    jstep_cfg = jax_make_step_config(e["jcfg"])
    step_cfg = make_step_config(e["cfg"])
    batch = dict(next(iter(e["loaders"][name])))
    if task == "det":
        cdn = step_cfg.cdn
        shape = (batch["img"].shape[0], 2 * cdn.num_groups, cdn.single_pad)
        rng = np.random.default_rng(5)
        batch.update(
            dn_noise_p=rng.uniform(size=shape).astype(np.float32),
            dn_noise_new_label=rng.integers(0, 20, shape).astype(np.int32),
            dn_noise_sign=(rng.integers(0, 2, shape + (4,)) * 2.0 - 1.0
                           ).astype(np.float32),
            dn_noise_part=rng.uniform(size=shape + (4,)).astype(np.float32))
    with HIGHEST:
        want = jax_make_val_step(e["jm"], task, jstep_cfg)(
            e["params"], {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
    e["model"].train()
    before = {k: v.clone() for k, v in e["model"].state_dict().items()}
    got = make_val_step(e["model"], task, step_cfg)(
        batch, torch.Generator().manual_seed(0))
    assert not e["model"].training
    assert all(torch.equal(v, e["model"].state_dict()[k])
               for k, v in before.items())
    assert set(got) == set(want), (sorted(got), sorted(want))
    assert "grad_norm" not in got and all(
        not v.requires_grad for v in got.values())
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-3, atol=2e-4, err_msg=key)


def test_make_eval_fn(evaluated):
    """``eval_fn()`` is ``evaluate_results`` over ``single_device_test`` of
    the val sets (and puts the model in eval mode); ``skip_det`` drops det,
    ``max_batches`` cuts each set."""
    e = evaluated
    kw = {t: dict(e["cfg"]["evaluation"].get(t, {}))
          for t in ("cls", "det", "seg")}
    want = evaluate_results(e["ds"], e["res"], kw)
    e["model"].train()
    got = make_eval_fn(e["cfg"], e["model"], max_per_img=e["k"])()
    assert not e["model"].training
    same_metrics(got, want)
    assert sorted(got) == sorted(jax_evaluate_results(e["jds"], e["jres_k"],
                                                      kw))
    short = make_eval_fn(e["cfg"], e["model"], max_per_img=e["k"],
                         skip_det=True, max_batches=1)()
    assert sorted(short) == sorted(k for k in want
                                   if not k.startswith("dior."))
