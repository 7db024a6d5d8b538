"""The serving slice end to end: the tiny config's cls and det tasks through
the port's ``make_infer_steps`` against the JAX package's, with the same
weights (carried across by ``state_dict_from_jax``) and the same
numpy-seeded uint8 inputs, float32, JAX under highest matmul precision.

Tolerances: cls probabilities 1e-5; det scores 1e-5 and boxes 1e-3 pixels
(absolute); labels equal. The top-k cut is only stable if no two scores
straddle it within the error, so the test also asserts that JAX's gap
between the last kept and the first dropped score exceeds 10x the score
tolerance for this seed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rscotr_tpu.engine import make_infer_steps as jax_make_infer_steps
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu_torch.engine import make_infer_steps
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.utils.config import load_model_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
CLS_TOL, SCORE_TOL, BOX_TOL = 1e-5, 1e-5, 1e-3


@pytest.fixture(scope="module")
def slice_models():
    cfg = load_model_cfg(TINY)
    jm = jax_build_model(cfg)
    params = jax.jit(lambda k: jm.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32)))(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.asarray(x).copy(), params["params"])
    model = build_model(cfg, tasks=("cls", "det"), device="cpu")
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    max_per_img = cfg["test_cfg"]["det"]["max_per_img"]
    return jm, params, model, max_per_img


def _inputs():
    # seed 3: JAX's cut gaps are 3.8e-4 and 7.0e-4 (>= 10x SCORE_TOL)
    rng = np.random.default_rng(3)
    cls_img = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    det_img = rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    hw = np.array([[128, 128], [100, 120]], np.int32)   # one padded image
    scale_factor = np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]],
                            np.float32)
    return cls_img, det_img, hw, scale_factor


def test_cls_matches_jax(slice_models):
    jm, params, model, _ = slice_models
    cls_img = _inputs()[0]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_make_infer_steps(jm)["cls"](
            params, jnp.asarray(cls_img)))
    got = make_infer_steps(model)["cls"](cls_img)
    assert got.shape == (2, 45) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLS_TOL)


def test_det_matches_jax(slice_models):
    jm, params, model, k = slice_models
    _, det_img, hw, sf = _inputs()
    # JAX keeps one more detection: its score sits just below the cut
    with jax.default_matmul_precision("highest"):
        jdet, jlabels = jax_make_infer_steps(jm, max_per_img=k + 1)["det"](
            params, jnp.asarray(det_img), jnp.asarray(hw), jnp.asarray(sf))
    jdet, jlabels = np.asarray(jdet), np.asarray(jlabels)
    gap = jdet[:, k - 1, 4] - jdet[:, k, 4]
    assert np.all(gap > 10 * SCORE_TOL), gap

    det, labels = make_infer_steps(model, max_per_img=k)["det"](det_img, hw,
                                                                sf)
    assert det.shape == (2, k, 5) and labels.shape == (2, k)
    np.testing.assert_array_equal(labels.numpy(), jlabels[:, :k])
    np.testing.assert_allclose(det[..., 4].numpy(), jdet[:, :k, 4], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(det[..., :4].numpy(), jdet[:, :k, :4],
                               rtol=0, atol=BOX_TOL)


def test_port_imports_no_jax():
    """Importing every module of rscotr_tpu_torch (and chip_smoke) leaves
    jax, flax, the JAX package and the root tools package out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rscotr_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(rscotr_tpu_torch.__path__,\n"
        "                               'rscotr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'rscotr_tpu', 'tools'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('rscotr_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20, res.stdout
