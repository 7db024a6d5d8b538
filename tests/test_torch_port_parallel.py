"""The port's scale-out helpers (rscotr_tpu_torch/parallel/) against the
JAX package's (rscotr_tpu/parallel/), in one process.

* ``merge_strided_results`` and ``pad_batch_to_devices`` equal JAX's
  exactly; ``all_gather_pyobjects`` at P == 1 returns ``[obj]`` and makes
  no process group.
* FSDP: the dim that the port shards each parameter of the tiny MTL on
  (``fsdp_param_dims``, in the port's layout) is the dim JAX's
  ``fsdp_param_specs`` shards the same leaf on over the 8-device CPU mesh,
  mapped through the weight converter, leaf by leaf, at three
  ``min_leaf_size`` values; the Swin ``attn.qkv`` / ``attn.proj`` fixed
  dims included. The DINO label embedding, which the det loss reads before
  ``forward_det``, stays whole on purpose (``READ_OUTSIDE_FORWARD``).
  The leaves are mapped by the converter itself: each JAX leaf becomes an
  array that counts along its sharded dim, and the port dim along which
  the converted tensor varies is the dim JAX's spec names.
* TP: ``tp_param_specs`` against JAX's on a (data 4, model 2) mesh, the
  same way (the fused ``in_proj`` sharded per q / k / v part where JAX
  shards q_proj, k_proj and v_proj).
* ``describe_fsdp`` / ``describe_tp`` give JAX's byte counts.
* The kernel wrappers refuse a DTensor.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

import rscotr_tpu.parallel as jpar
from rscotr_tpu.config import Config
from rscotr_tpu.models import build_model as jax_build_model
from rscotr_tpu.parallel import multihost as jmulti
from rscotr_tpu_torch.models import build_model
from rscotr_tpu_torch.parallel import fsdp, multihost, tp
from rscotr_tpu_torch.parallel.mesh import pad_batch_to_devices
from rscotr_tpu_torch.utils.config import load_cfg
from rscotr_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")


@pytest.fixture(scope="module")
def tiny():
    """(JAX param shapes, the port's model) of the tiny config."""
    jmodel = jax_build_model(Config.fromfile(TINY).model)
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, cls_img=jnp.zeros((1, 64, 64, 3)),
        det_img=jnp.zeros((1, 128, 128, 3)),
        det_img_hw=jnp.array([[128, 128]], jnp.int32),
        seg_img=jnp.zeros((1, 64, 64, 3))), jax.random.key(0))["params"]
    model = build_model(load_cfg(TINY)["model"], device="cpu")
    return shapes, model


def test_merge_strided_results_equals_jax():
    rng = np.random.default_rng(0)
    shards = []
    for r in range(3):
        shards.append({
            "a": [(int(i), rng.normal(size=2)) for i in range(r, 11, 3)],
            "b": [(int(i), int(i) * 10) for i in range(r, 7, 3)]})
    got = multihost.merge_strided_results(shards)
    want = jmulti.merge_strided_results(shards)
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,devices", [(5, 4), (8, 4), (3, 8), (1, 2)])
def test_pad_batch_to_devices_equals_jax(n, devices):
    rng = np.random.default_rng(n)
    batch = {"img": rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
             "hw": rng.integers(0, 9, (n, 2)).astype(np.int32)}
    got, gn = pad_batch_to_devices(batch, devices)
    want, wn = jpar.pad_batch_to_devices(batch, devices)
    assert gn == wn
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_all_gather_pyobjects_single_process():
    import torch.distributed as dist
    obj = {"x": [1, 2], "y": np.arange(3)}
    got = multihost.all_gather_pyobjects(obj)
    assert got == [obj] or (len(got) == 1 and got[0] is obj)
    assert jmulti.all_gather_pyobjects(obj)[0] is obj
    assert not dist.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.all_reduce_max([3, 1]) == [3, 1]


def _port_dims_of(shapes, specs, axis: str) -> dict:
    """{port parameter name: the port dim JAX's ``specs`` shard over
    ``axis`` (None: not sharded)}, through ``state_dict_from_jax``."""
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, NamedSharding))
    markers = []
    for (_, leaf), sh in zip(flat, spec_leaves):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        d = next((i for i, a in enumerate(spec) if a == axis), None)
        m = np.zeros(leaf.shape, np.float32)
        if d is not None:
            idx = [None] * len(leaf.shape)
            idx[d] = slice(None)
            m = m + (np.arange(leaf.shape[d], dtype=np.float32)
                     + 1.0)[tuple(idx)]
        markers.append(m)
    tree = jax.tree.unflatten(jax.tree.structure(shapes), markers)
    out = {}
    for name, t in state_dict_from_jax(tree).items():
        t = np.asarray(t)
        varies = [d for d in range(t.ndim)
                  if t.shape[d] > 1 and not np.all(
                      np.diff(t, axis=d) == 0)]
        assert len(varies) <= 1, (name, varies)
        out[name] = varies[0] if varies else None
    return out


@pytest.mark.parametrize("min_leaf", [fsdp.DEFAULT_MIN_LEAF_SIZE, 1024, 64])
def test_fsdp_dims_equal_jax_leaf_by_leaf(tiny, cpu_mesh, min_leaf):
    shapes, model = tiny
    specs = jpar.fsdp_param_specs(shapes, cpu_mesh, min_leaf_size=min_leaf)
    want = _port_dims_of(shapes, specs, "data")
    got = fsdp.fsdp_param_dims(model, 8, min_leaf)
    assert set(got) == set(want)
    for name in fsdp.READ_OUTSIDE_FORWARD:
        assert got.pop(name) is None
        want.pop(name)
    bad = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert not bad, bad
    # the fixed dims of the Swin window attention: qkv on its input (port
    # dim 1), proj on its output (port dim 0), wherever they shard
    for n, d in got.items():
        if d is not None and n.endswith("attn.w_msa.qkv.weight"):
            assert d == 1, n
        if d is not None and n.endswith("attn.w_msa.proj.weight"):
            assert d == 0, n
    assert any(d is not None for d in got.values())


def test_tp_placements_equal_jax(tiny):
    shapes, model = tiny
    mesh = jpar.make_mesh_2d(4, 2)
    want = _port_dims_of(shapes, jpar.tp_param_specs(shapes, mesh), "model")
    got = tp.tp_param_specs(model, 2)
    assert set(got) == set(want)
    bad = {n: (got[n], want[n]) for n in got if got[n] != want[n]}
    assert not bad, bad
    kinds = {n: d for n, d in got.items() if d is not None}
    assert any("ffn.layers.0.0" in n and n.startswith("backbone.")
               for n in kinds)
    assert any("value_proj" in n for n in kinds)
    assert any("in_proj_weight" in n for n in kinds)
    assert not any("w_msa" in n for n in kinds)


def _mb(text: str):
    """The byte counts of a describe line: "x MB", "(x/y MB)"."""
    return [float(x) for x in re.findall(r"([\d.]+)(?=/[\d.]+ MB| MB)",
                                         text)]


@pytest.mark.parametrize("min_leaf", [fsdp.DEFAULT_MIN_LEAF_SIZE, 1024])
def test_describe_byte_counts_equal_jax(tiny, cpu_mesh, min_leaf):
    shapes, model = tiny
    # JAX's describe reads .nbytes off the leaves
    arrays = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = jpar.describe_fsdp(arrays, cpu_mesh, min_leaf_size=min_leaf)
    got = fsdp.describe_fsdp(model, 8, min_leaf)
    assert _mb(got) == _mb(want), (got, want)
    mesh = jpar.make_mesh_2d(4, 2)
    want_tp = jpar.describe_tp(arrays, mesh)
    got_tp = tp.describe_tp(model, 2, 4)
    assert _mb(got_tp) == _mb(want_tp), (got_tp, want_tp)


def test_kernel_wrappers_refuse_a_dtensor():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from rscotr_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from rscotr_tpu_torch.ops.window_attention import window_attention

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dt = distribute_tensor(torch.zeros(1, 4, 2, 8), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ms_deform_attn(dt, [(2, 2)], torch.zeros(1, 3, 2, 1, 1, 2),
                           torch.ones(1, 3, 2, 1, 1))
        q = distribute_tensor(torch.zeros(1, 1, 1, 4, 8), mesh,
                              [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            window_attention(q, q, q, torch.zeros(1, 4, 4))
    finally:
        dist.destroy_process_group()
