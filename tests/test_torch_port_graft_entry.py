"""The port's driver entry (``rscotr_tpu_torch/graft_entry.py``, ROADMAP M12)
on the CPU, against the root ``__graft_entry__.py``'s JAX package:

* ``entry(device="cpu", config=TINY, det_hw=(128, 128))`` with JAX's tiny
  init carried across as ``params``, on a seeded random image, against
  JAX's ``forward_det`` (jitted, highest matmul precision): every output
  within 1e-4 (float32 sums in another order; the slice tests' det score
  tolerance is 1e-5 after the sigmoid, the raw logits here get 1e-4);
* ``entry(device="cpu")`` at full width (the paper MTL): ``fn`` equals
  ``model.forward_det`` of a model built with another seed, given that
  model's weights, bit for bit;
* the trajectory leg in one process from JAX's initial ``MiniCls`` weights
  (flax's init reproduced here with the helper's module) against
  ``tests/helpers/dist_trajectory.py --num-processes 1 --local-devices 1``:
  losses and final weights at rtol 1e-4 / atol 1e-6;
* a CUDA device without a card raises; a rank that raises fails the call
  with its log tail, and a run past its timeout kills its ranks and
  raises, each within seconds.

Every spawned process has its own time limit. The four-rank dry run
against JAX is test_torch_port_graft_dryrun.py.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch import graft_entry
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
HIGHEST = jax.default_matmul_precision("highest")
OUT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch keeps to 2 threads beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def tnp(tree):
    return jax.tree.map(lambda x: np.asarray(x).copy(), tree)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's tiny MTL and its seed-0 init (every head)."""
    jm = jax_build_model(load_cfg(TINY)["model"])
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))))(jax.random.key(0))
    return jm, tnp(params)


def test_entry_tiny_matches_jax_forward_det(jax_tiny):
    jm, params = jax_tiny
    fn, (p0, img0, hw) = graft_entry.entry(device="cpu", config=TINY,
                                           det_hw=(128, 128))
    assert tuple(img0.shape) == (1, 128, 128, 3) and img0.device.type == \
        "cpu" and hw.tolist() == [[128, 128]]
    weights = {k: v for k, v in state_dict_from_jax(
        params["params"]).items()}
    assert set(weights) == set(p0)
    img = np.random.default_rng(5).normal(size=(1, 128, 128, 3)).astype(
        np.float32)
    got = fn(weights, torch.from_numpy(img), hw)
    with HIGHEST:
        want = jax.jit(lambda p, x, h: jm.apply(
            p, x, h, deterministic=True, method=jm.forward_det))(
            params, jnp.asarray(img), jnp.asarray(hw.numpy()))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OUT_TOL,
                                   atol=OUT_TOL)


def test_entry_full_width_is_forward_det():
    fn, (params, img, hw) = graft_entry.entry(device="cpu")
    assert tuple(img.shape) == (1, 256, 256, 3) and not img.any()
    assert hw.tolist() == [[256, 256]] and hw.dtype == torch.int32
    cfg = load_cfg(graft_entry.FLAGSHIP_CFG)
    other = build_model(cfg["model"], device="cpu",
                        generator=torch.Generator().manual_seed(1)).eval()
    # the example weights are the seed-0 model's, not the other's: fn
    # gives the other's outputs only if it runs on the weights it is given
    assert set(params) == set(other.state_dict())
    assert not torch.equal(params["bbox_head.transformer.query_embed.weight"],
                           other.state_dict()[
                               "bbox_head.transformer.query_embed.weight"])
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 256, 256, 3)).astype(np.float32))
    got = fn(other.state_dict(), x, hw)
    with torch.no_grad():
        want = other.forward_det(x, hw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


class _FlaxMiniCls(fnn.Module):
    """tests/helpers/dist_trajectory.py's MiniCls, for its init."""
    num_classes: int = 7
    hidden: int = 64

    def setup(self):
        self.proj = fnn.Dense(self.hidden)
        self.head = fnn.Dense(self.num_classes)

    def __call__(self, img, deterministic=True):
        return self.head(fnn.relu(self.proj(img.mean(axis=(1, 2)))))


def test_trajectory_one_process_matches_jax_helper(tmp_path):
    helper = os.path.join(ROOT, "tests", "helpers", "dist_trajectory.py")
    out = str(tmp_path / "single.pkl")
    proc = subprocess.Popen(
        [sys.executable, helper, "--num-processes", "1", "--local-devices",
         "1", "--out", out], env=dict(os.environ, JAX_PLATFORMS="cpu"),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    flax_p = _FlaxMiniCls().init(jax.random.key(0),
                                 jnp.zeros((8, 8, 8, 3)))["params"]
    init = {f"{m}.{n}": np.asarray(flax_p[m][k]).T if k == "kernel" else
            np.asarray(flax_p[m][k])
            for m in ("proj", "head") for k, n in (("kernel", "weight"),
                                                   ("bias", "bias"))}
    got = graft_entry.trajectory(0, 1, "cpu", str(tmp_path / "wd"),
                                 init=init)
    log = proc.communicate(timeout=180)[0]
    assert proc.returncode == 0, log.decode()[-2000:]
    with open(out, "rb") as f:
        want = pickle.load(f)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               atol=1e-6)
    for m in ("proj", "head"):
        np.testing.assert_allclose(got["params"][f"{m}.weight"],
                                   want["params"]["params"][m]["kernel"].T,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["params"][f"{m}.bias"],
                                   want["params"]["params"][m]["bias"],
                                   rtol=1e-4, atol=1e-6)
    assert len(got["eval_metrics"]) == len(want["eval_metrics"]) == 2
    assert got["best_ckpt"] is not None


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("case", ["rank raises", "timeout"])
def test_a_failing_rank_or_a_timeout_raises_with_the_log_tail(case):
    t0 = time.monotonic()
    if case == "rank raises":
        with pytest.raises(RuntimeError) as err:
            graft_entry.dryrun_multichip(
                2, device="cpu", weights={"bogus": np.zeros(1)}, timeout=120)
        assert "legs rank" in str(err.value) and "exited with" in \
            str(err.value)
        assert "bogus" in str(err.value)     # the rank's traceback
    else:
        with pytest.raises(RuntimeError, match="timed out"):
            graft_entry.dryrun_multichip(2, device="cpu", timeout=1.0)
    assert time.monotonic() - t0 < 60
