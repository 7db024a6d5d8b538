"""``dryrun_multichip(4, device="cpu")`` of the port's driver entry
(``rscotr_tpu_torch/graft_entry.py``, ROADMAP M12) with four gloo ranks,
started from JAX's tiny init (``weights=``): every leg's line and ``OK``,
and its first data-parallel step per task (cls, det, seg in turn, the cls
augments off as ROADMAP C15 asks, the same CDN noise) against JAX's
one-process ``make_train_step`` on the global batch at the train-slice
tolerances (rtol 2e-3 / atol 2e-4, as test_torch_port_dist_train.py).
JAX's reference steps run while the dry run's ranks do; the dry run has
its own time limit, and so does every rank it spawns.
"""

import dataclasses
import os
import threading

import numpy as np

import jax
import jax.numpy as jnp

from rscotr_tpu.apis import make_step_config as jax_make_step_config
from rscotr_tpu.config import Config
from rscotr_tpu.engine import build_optimizer as jax_build_optimizer
from rscotr_tpu.engine import make_train_step as jax_make_train_step
from rscotr_tpu.engine import task_param_masks as jax_task_param_masks
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch import graft_entry
from rscotr_tpu_torch.apis import make_step_config
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
HIGHEST = jax.default_matmul_precision("highest")
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4


def _jax_tiny():
    """JAX's tiny MTL and its seed-0 init (every head), as numpy."""
    jm = jax_build_model(load_cfg(TINY)["model"])
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    return jm, jax.tree.map(lambda x: np.asarray(x).copy(), params)


def _jax_first_steps(jm, params, n):
    """JAX's one-process steps cls, det, seg in turn on the dry run's
    global batches (``graft_entry.dryrun_batches``), the cls augments off:
    each step's log vars."""
    jcfg = Config.fromfile(TINY)
    step_cfg = dataclasses.replace(jax_make_step_config(jcfg),
                                   cls_use_augments=False)
    cdn = make_step_config(load_cfg(TINY)).cdn
    batches = graft_entry.dryrun_batches(n, cdn)
    opt = jax_build_optimizer(
        jcfg.optimizer, params["params"], lr_config=dict(jcfg.lr_config),
        grad_clip=jcfg.optimizer_config["grad_clip"])
    masks = jax_task_param_masks(params["params"])
    state, logs = opt.init(params["params"]), {}
    with HIGHEST:
        for task in ("cls", "det", "seg"):
            step = jax_make_train_step(jm, opt, task, step_cfg, masks[task],
                                       donate=False)
            params, state, lv = step(
                params, state, {k: jnp.asarray(v) for k, v in
                                batches[task].items()}, jax.random.key(1))
            logs[task] = {k: float(v) for k, v in lv.items()}
    return logs


def test_dryrun_multichip_four_gloo_ranks_vs_jax(capsys):
    jm, params = _jax_tiny()
    weights = state_dict_from_jax(params["params"])
    box = {}

    def run():
        try:
            box["out"] = graft_entry.dryrun_multichip(
                4, device="cpu", weights={k: v.numpy() for k, v in
                                          weights.items()}, timeout=240)
        except BaseException as e:   # re-raised in the test's thread
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    try:
        want = _jax_first_steps(jm, params, 4)
    finally:
        t.join(timeout=300)
    assert not t.is_alive()
    if "err" in box:
        raise box["err"]
    out = box["out"]
    printed = capsys.readouterr().out
    for leg in ("cls: loss=", "det: loss=", "seg: loss=",
                "cls group K=2: loss=", "cls devaug", "det devaug",
                "seg devaug", "eval: ", "[4 fsdp] det: loss=",
                "[4 fsdp] checkpoint gather/save/restore",
                "[2x2 dp*tp] cls: loss=", "trajectory == 1 process",
                "dryrun_multichip(4) OK"):
        assert leg in printed, leg
    assert out["backend"] == "gloo" and out["devices"] == ["cpu"] * 4
    for task in ("cls", "det", "seg"):
        np.testing.assert_allclose(out[task], want[task]["loss"],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=task)
    assert len(out["cls group K=2"]) == 2
    assert any(k.endswith("accuracy_top-1") for k in out["eval"])
