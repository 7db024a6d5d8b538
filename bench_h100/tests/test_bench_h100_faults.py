"""A run with its timed path broken underneath comes out not correct, and
a sound run correct: the whole harness (driver, window, free, reference,
judge) on the tiny MTL on the CPU, with the look for a card skipped and
each cell's own limits. The control, the reference in float8 in the
program's place, is kept here at the tiny size too."""

import pytest
import torch

from bench_h100 import harness, run as brun
from bench_h100.tests import _tiny

SEED = 2 ** 31 + 7
CELLS = _tiny.CELLS
DET_CELLS = [c for c in CELLS
             if _tiny.cell(c).workload["check"] == "det"]


def _run(cell):
    return brun.run_cell(cell, SEED, 0.5, 0, device="cpu", t0=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, run, table = _run(_tiny.cell(name))
    assert ok, table
    assert run.requests > 0 and run.checked


def _broken(monkeypatch, fault):
    """Replace the serving entries under the serve driver by a broken copy."""
    from rscotr_tpu_torch.engine import infer
    real = infer.make_infer_steps

    def make(model, *a, **k):
        steps = real(model, *a, **k)

        def cls(img):
            return fault("cls", steps["cls"], img)

        def det(img, hw):
            return fault("det", lambda x: steps["det"](x, hw), img)
        return {"cls": cls, "det": det}
    monkeypatch.setattr(infer, "make_infer_steps", make)


def _half_left_out(task, fn, img):
    """Half of the batch computed, the other half answered with it."""
    half = img.shape[0] // 2
    out = fn(img[:half])
    if task == "det":
        return tuple(torch.cat([o, o]) for o in out)
    return torch.cat([out, out])


def _answer_altered(task, fn, img):
    """The last image's answer changed where it is produced: its first
    detection's class, or its class probabilities, moved by one class."""
    out = fn(img)
    if task == "det":
        boxes, labels = out
        labels = labels.clone()
        labels[-1, 0] = (labels[-1, 0] + 1) % 20
        return boxes, labels
    out = out.clone()
    out[-1] = out[-1].roll(1)
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_entry_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    ok, run, table = _run(_tiny.cell(name))
    assert not ok, table


def _lowest(order, k):
    """The k lowest-scoring (slot, class) pairs, best first."""
    return torch.arange(order.shape[1] - k, order.shape[1]).expand(
        order.shape[0], k)


def _first(order, k):
    """The first k (slot, class) pairs in slot order."""
    return order.argsort(1)[:, :k]


@pytest.mark.parametrize("pick", [_lowest, _first])
@pytest.mark.parametrize("name", DET_CELLS)
def test_wrong_top_k_is_not_correct(monkeypatch, name, pick):
    """The serving entry serves another set of detections than its top k,
    each a true slot's box and score under its class."""
    from rscotr_tpu_torch.engine import infer
    real = infer.dino_get_bboxes

    def wrong(cls_scores, bbox_preds, img_hw, scale_factor=None,
              max_per_img=300, rescale=False):
        B, Nq, K = cls_scores.shape
        # every pair, best first, and which pair each row is
        det, labels = real(cls_scores, bbox_preds, img_hw, scale_factor,
                           max_per_img=Nq * K, rescale=rescale)
        order = cls_scores.sigmoid().reshape(B, -1).topk(Nq * K, dim=1)[1]
        rows = pick(order, max_per_img).to(det.device)
        return (det.gather(1, rows[..., None].expand(-1, -1, 5)),
                labels.gather(1, rows))
    monkeypatch.setattr(infer, "dino_get_bboxes", wrong)
    ok, run, table = _run(_tiny.cell(name))
    assert not ok, table
    assert table["topk_gap"]["value"] > 0, table
    assert table["det_gap"]["value"] <= table["det_gap"]["limit"], table


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name):
    """At the tiny size, the fp8 control in the bf16 program's place on
    the same sampled requests comes out not correct at the cell's limits,
    and reads at least 3x the program on some number."""
    from bench_h100 import calibrate
    cell = _tiny.cell(name, dtype="bfloat16")
    ok, run, _ = _run(cell)
    ctrl = calibrate.control_numbers(cell, SEED, run, "cpu")
    assert set(ctrl) == set(cell.workload["limits"])
    correct, table = harness.judge(ctrl, cell.workload["limits"])
    assert not correct, table
    assert any(ctrl[k] >= 3 * run.numbers[k] for k in ctrl), \
        (run.numbers, ctrl)
