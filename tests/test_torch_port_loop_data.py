"""The port's training data side against the JAX package's: the iteration
strategies (every name and alias, draw for draw), the DN-width ladder of
every file of configs/, the det collate's ``dn_wide`` marker, the
``MultiDataLoader`` over the tiny config's train sets (every batch equal,
array for array, over three epochs of its smallest loader), and
``PrefetchIterator``. Everything here is host-side numpy and must be
exactly equal.
"""

import glob
import os
import time
import types

import numpy as np
import pytest

from rscotr_tpu.config import Config
from rscotr_tpu.data import build_datasets as jax_build_datasets
from rscotr_tpu.data import load_data_cfg as jax_load_data_cfg
from rscotr_tpu.data.build import build_multidataloader as jax_build_mdl
from rscotr_tpu.data.build import derive_dn_ladder as jax_derive_dn_ladder
from rscotr_tpu.data.iteration_strategies import \
    strategies_map as jax_strategies
from rscotr_tpu.data.loader import collate_det as jax_collate_det
from rscotr_tpu_torch.data.build import (build_datasets,
                                         build_multidataloader,
                                         derive_dn_ladder, load_data_cfg)
from rscotr_tpu_torch.data.iteration_strategies import strategies_map
from rscotr_tpu_torch.data.loader import (PrefetchIterator, collate_det,
                                          dn_wide_marker)
from rscotr_tpu_torch.utils.config import load_cfg, merge_from_dict
from rscotr_tpu_torch.utils.registry import STRATEGIES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs/multi/MTL_tiny_synthetic.py")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.py"), recursive=True))

# keyword arguments that make each strategy draw something non-trivial
STRATEGY_KW = {"constant": dict(idx=1), "round_robin": dict(start_idx=2),
               "repeated_sequence": dict(sequence=[1, 2, 2, 0, 0, 0]),
               "weighted_random": dict(p=[0.5, 0.3, 0.2]),
               "batch-weighted_random": dict(p=[0.1, 0.1, 0.8])}


def _loaders():
    return {n: types.SimpleNamespace(dataset=[0] * size)
            for n, size in (("a", 32), ("b", 16), ("c", 48))}


# ---------------------------------------------------------------------------
# iteration strategies
# ---------------------------------------------------------------------------

def test_strategy_names_match_jax():
    assert sorted(strategies_map) == sorted(jax_strategies)
    for name, cls in strategies_map.items():
        assert STRATEGIES.get(name) is cls
        assert cls.__name__ == jax_strategies[name].__name__
        assert cls.should_exhaust_all_iterators == \
            jax_strategies[name].should_exhaust_all_iterators


@pytest.mark.parametrize("name", sorted(jax_strategies))
def test_strategy_draws_match_jax(name):
    """The first 1,000 draws at seed 5, then 1,000 more after set_step(17),
    equal JAX's."""
    kw = STRATEGY_KW.get(name, {})
    got = strategies_map[name](_loaders(), seed=5, **kw)
    want = jax_strategies[name](_loaders(), seed=5, **kw)
    a = [got() for _ in range(1000)]
    assert a == [want() for _ in range(1000)]
    assert all(type(x) is int and 0 <= x < 3 for x in a)
    got.set_step(17)
    want.set_step(17)
    assert [got() for _ in range(1000)] == [want() for _ in range(1000)]


# ---------------------------------------------------------------------------
# DN ladder and the det collate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_dn_ladder_matches_jax(path):
    p = os.path.join(ROOT, path)
    assert derive_dn_ladder(load_cfg(p)) == jax_derive_dn_ladder(
        Config.fromfile(p, import_custom_modules=False))


@pytest.mark.parametrize("opts", [
    dict(max_gt=30, dn_max_gt=8, num_dn=100),
    dict(max_gt=100, dn_max_gt=10, num_dn=300),
    dict(max_gt=12, dn_max_gt=20, num_dn=100),
    dict(max_gt=100, dn_max_gt=20, num_dn=100, dn_widen=False)])
def test_dn_ladder_matches_jax_off_the_configs(opts):
    """Ladders the configs do not reach: other group counts, a dn_max_gt
    above max_gt, and a loader that turns the widening off."""
    loader = dict(max_gt=opts["max_gt"])
    if "dn_widen" in opts:
        loader["dn_widen"] = opts["dn_widen"]
    cfg = dict(
        model=dict(bbox_head=dict(dn_cfg=dict(group_cfg=dict(
            dn_max_gt=opts["dn_max_gt"], num_dn_queries=opts["num_dn"])))),
        data=dict(dior=dict(task="det", loader=loader, data={})))
    got = derive_dn_ladder(cfg)
    assert got == jax_derive_dn_ladder(Config.fromdict(cfg))
    assert (got is None) == ("dn_widen" in opts)


def _det_samples(rng, counts, hw=(96, 128)):
    out = []
    for n in counts:
        xy = rng.uniform(0, 60, (n, 2))
        out.append(dict(
            img=rng.uniform(0, 255, hw + (3,)).astype(np.float32),
            gt_bboxes=np.concatenate([xy, xy + 20], 1).astype(np.float32),
            gt_labels=rng.integers(0, 20, n).astype(np.int32),
            scale_factor=np.ones(4, np.float32)))
    return out


@pytest.mark.parametrize("counts", [(0, 0), (3, 7), (21, 2), (40, 60),
                                    (120, 5)],
                         ids=["empty", "sparse", "one_over", "crowded",
                              "over_max_gt"])
def test_collate_det_with_ladder_matches_jax(counts):
    """Every array and the ``dn_wide`` width equal JAX's, from batches
    with no GT to ones past max_gt (the last rung, 100, then)."""
    ladder = (20, 25, 33, 50, 100)
    samples = _det_samples(np.random.default_rng(sum(counts)), counts)
    got = collate_det(samples, (128, 128), 100, dn_ladder=ladder)
    want = jax_collate_det(samples, (128, 128), 100, dn_ladder=ladder)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = min(max(counts), 100)
    assert got["dn_wide"].shape == (0, next(r for r in ladder if r >= n))
    assert "dn_wide" not in collate_det(samples, (128, 128), 100)


def test_dn_wide_marker_takes_the_last_rung_past_the_ladder():
    assert dn_wide_marker(0, (20, 25)).shape == (0, 20)
    assert dn_wide_marker(25, (25, 20)).shape == (0, 25)
    assert dn_wide_marker(26, (20, 25)).shape == (0, 25)


# ---------------------------------------------------------------------------
# MultiDataLoader
# ---------------------------------------------------------------------------

def _stream(mdl, n_epochs):
    """Every batch of ``n_epochs`` passes, re-seeded at each end as the
    runner re-seeds at its step."""
    out, drawn = [], 0
    for _ in range(n_epochs):
        for b in mdl:
            out.append(b)
            drawn += 1
        mdl.seed_sampler(drawn)
    return out


def _capped(mdl, n):
    it = iter(mdl)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("strategy", ["round_robin", "constant"])
def test_multidataloader_matches_jax(strategy):
    """The tiny config's train sets through each package's
    ``build_multidataloader``: the same (task, dataset_name, every array)
    sequence. round_robin re-ignites its children (3 epochs of the
    smallest loader, 8 batches: 72 draws); constant (exhaust-all) ends an
    epoch when every child is done (32 batches) and is run for 3."""
    opts = {"iteration_strategy": {"type": strategy}}
    jcfg = Config.fromfile(TINY)
    jcfg.merge_from_dict(opts)
    jcfg = jax_load_data_cfg(jcfg, config_root=ROOT)
    cfg = load_data_cfg(merge_from_dict(load_cfg(TINY), opts),
                        config_root=ROOT, filename=TINY)
    got_mdl = build_multidataloader(cfg, build_datasets(cfg["data"]), seed=3)
    want_mdl = jax_build_mdl(jcfg, jax_build_datasets(jcfg.data), seed=3)
    assert [len(dl) for dl in got_mdl.loaders.values()] == [8, 16, 8]
    if strategy == "round_robin":
        got, want = _capped(got_mdl, 72), _capped(want_mdl, 72)
    else:
        got, want = _stream(got_mdl, 3), _stream(want_mdl, 3)
        assert len(got) == 3 * 32
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, (i, k)
                np.testing.assert_array_equal(g[k], v, err_msg=f"{i} {k}")
            else:
                assert g[k] == v, (i, k)
    tasks = [b["task"] for b in got]
    assert set(tasks) == {"cls", "det", "seg"}
    dets = [b for b in got if b["task"] == "det"]
    assert all(b["dn_wide"].shape == (0, 20) for b in dets)


# ---------------------------------------------------------------------------
# PrefetchIterator
# ---------------------------------------------------------------------------

def test_prefetch_keeps_order_and_ends_cleanly():
    seen = []
    it = PrefetchIterator(iter(range(50)), depth=3,
                          transfer_fn=lambda x: seen.append(x) or x * 2)
    assert list(it) == [2 * i for i in range(50)]
    assert seen == list(range(50))
    with pytest.raises(StopIteration):
        next(it)            # a second call after the end ends the same way
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_prefetch_surfaces_a_worker_error():
    def gen():
        yield 1
        yield 2
        raise OSError("disk gone")

    it = PrefetchIterator(gen(), depth=2)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
        next(it)
    assert isinstance(e.value.__cause__, OSError)

    def bad_transfer(x):
        raise ValueError("no card")

    it = PrefetchIterator(iter(range(3)), transfer_fn=bad_transfer)
    with pytest.raises(RuntimeError) as e:
        next(it)
    assert isinstance(e.value.__cause__, ValueError)


def test_prefetch_close_stops_a_full_worker():
    """A worker blocked on its full queue ends on close(), its iterator
    left where it was."""
    made = []

    def gen():
        for i in range(1000):
            made.append(i)
            yield i

    it = PrefetchIterator(gen(), depth=2)
    assert next(it) == 0
    deadline = time.monotonic() + 5
    while len(made) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    it.close()
    assert not it._thread.is_alive()
    assert len(made) < 10
