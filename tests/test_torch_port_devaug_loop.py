"""Co-training with on-device augmentation against the JAX package, on
configs/multi/MTL_tiny_synthetic_devaug.py (all three augment tails on the
device):

* the ``MultiDataLoader`` of each package (planners, aug collates, DN
  ladder): every batch equal, array for array, over 30 round_robin draws,
  which run the 8-batch cls and seg loaders into their second epoch;
* ``train_model`` in both packages for 3 iterations (cls, det, seg: each
  step runs its task's device stage, the explicit normalize and, for det
  and seg, the pad mask), ``cls_use_augments=False``, ``validate=False``,
  from the same weights (JAX's init, handed to the port as
  ``load_from``), the same CDN noise fed to each det step as
  ``dn_noise_*`` entries. The tolerances are those of
  tests/test_torch_port_train_slice.py: every loss term and ``grad_norm``
  per iteration at rtol 2e-3 / atol 2e-4, the final parameters at 2e-4 +
  5e-3 * |w|.
"""

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
from rscotr_tpu.engine.hooks import Hook as JaxHook
from rscotr_tpu_torch.apis import make_step_config, train_model
from rscotr_tpu_torch.data.build import (build_datasets,
                                         build_multidataloader,
                                         load_data_cfg)
from rscotr_tpu_torch.engine.checkpoint import save_checkpoint
from rscotr_tpu_torch.engine.hooks import Hook
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
from rscotr_tpu_torch.utils.convert import state_dict_from_jax
from rscotr_tpu_torch.utils.registry import HOOKS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVAUG = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic_devaug.py")
ITERS = 3


def _cfgs(opts):
    jcfg = Config.fromfile(DEVAUG)
    jcfg.merge_from_dict(opts)
    jcfg = jax_load_data_cfg(jcfg, config_root=ROOT)
    cfg = load_data_cfg(merge_from_dict(load_cfg(DEVAUG), opts),
                        config_root=ROOT, filename=DEVAUG)
    return jcfg, cfg


def test_multidataloader_matches_jax():
    jcfg, cfg = _cfgs({})
    got_mdl = build_multidataloader(cfg, build_datasets(cfg["data"]), seed=3)
    want_mdl = jax_build_mdl(jcfg, jax_build_datasets(jcfg.data), seed=3)
    assert [len(dl) for dl in got_mdl.loaders.values()] == [8, 16, 8]
    got_it, want_it = iter(got_mdl), iter(want_mdl)
    for i in range(30):
        g, w = next(got_it), next(want_it)
        assert sorted(g) == sorted(w), i
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, \
                    (i, k)
                np.testing.assert_array_equal(g[k], v, err_msg=f"{i} {k}")
            else:
                assert g[k] == v, (i, k)
        assert g["img"].dtype == np.uint8
        assert any(k.startswith("aug_") for k in g), i
        if g["task"] == "det":
            assert g["out_template"].shape[1:] == (256, 256, 0)
            assert g["dn_wide"].shape == (0, 20)


# ---------------------------------------------------------------------------
# train_model, both packages
# ---------------------------------------------------------------------------

class _LossRecorder:
    """A custom hook that records every step's loss terms and grad_norm as
    floats, tagged by package."""
    priority = 80
    logs = []

    def after_train_iter(self, runner):
        self.logs.append((self.side, runner.step, {
            k: float(v) for k, v in runner.log_vars.items()
            if k not in ("data_time", "time")}))


for _name, _side, _reg, _base in (
        ("PortDevaugRecorder", "port", HOOKS, Hook),
        ("JaxDevaugRecorder", "jax", JAX_HOOKS, JaxHook)):
    if _name not in _reg:
        _reg.register_module(name=_name)(
            type(_name, (_LossRecorder, _base), {"side": _side}))


def _noise(j, cdn):
    shape = (1, 2 * cdn.num_groups, cdn.single_pad)
    rng = np.random.default_rng(300 + j)
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


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("devaug")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    opts = {"model.train_cfg.cls.augments": []}
    jcfg = _cfgs(dict(opts, custom_hooks=[
        dict(type="JaxDevaugRecorder")]))[0]
    cfg = _cfgs(dict(opts, custom_hooks=[
        dict(type="PortDevaugRecorder")]))[1]
    cdn = jax_apis.make_step_config(jcfg).cdn
    _LossRecorder.logs.clear()
    inits = []
    real_init, real_make = jax_apis.init_model_params, \
        jax_apis.make_train_step

    def init_params(model, cfg, seed=0):
        # JAX's init, jitted at small shapes; a host copy is kept, since the
        # jitted steps donate the arrays they are given
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
        with pytest.MonkeyPatch.context() as mp, \
                jax.default_matmul_precision("highest"):
            # no TensorBoard (it would import tensorflow)
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            jrunner = jax_apis.train_model(
                jcfg, str(tmp / "jax"), validate=False,
                max_iters_override=ITERS, num_devices=1)
            assert make_step_config(cfg).device_aug is not None
            init = build_model(cfg["model"], device="cpu")
            init.load_state_dict(state_dict_from_jax(inits[0]["params"]),
                                 strict=True)
            cfg["load_from"] = save_checkpoint(str(tmp / "init"), 0, init)
            mp.setattr(port_train_step, "make_train_step", _with_noise(
                port_train_step.make_train_step, cdn, np.asarray))
            runner = train_model(cfg, str(tmp / "port"), validate=False,
                                 max_iters_override=ITERS, device="cpu")
    finally:
        jax_apis.init_model_params = real_init
        jax_apis.make_train_step = real_make
        torch.set_num_threads(threads)
    final_jax = state_dict_from_jax(jax.tree.map(
        lambda x: np.asarray(x).copy(), jrunner.params["params"]))
    return dict(logs=list(_LossRecorder.logs), runner=runner,
                final_jax=final_jax)


@pytest.mark.parametrize("i", range(ITERS))
def test_train_model_losses_match_jax(loop, i):
    logs = {side: [(s, lv) for sd, s, lv in loop["logs"] if sd == side]
            for side in ("jax", "port")}
    assert [s for s, _ in logs["port"]] == [s for s, _ in logs["jax"]] == \
        list(range(1, ITERS + 1))
    want, got = logs["jax"][i][1], logs["port"][i][1]
    assert set(got) == set(want), (sorted(got), sorted(want))
    task = ("cls", "det", "seg")[i]
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
    assert loop["runner"].step == ITERS
