"""The port's soak (``rscotr_tpu_torch/tools/soak_flagship.py``) against the
root ``tools/soak_flagship.sh``.

* Summary parity: the root script's summary (its heredoc, read from the
  script's text) run with ``sys.executable`` and the port's ``summarize`` /
  ``check`` print the same lines, give the same numbers (the heredoc's
  variables, executed in a namespace) and fail alike (exit 1 and the
  message of its assert) on a flat run, a run that drifts +20%, a run with
  no eval record and the tiny soak's own ``metrics.jsonl``.
* The failure paths of the CLI (``python -m ...soak_flagship``'s ``main``
  in a process of its own, its train tool replaced by a stand-in that
  writes checkpoints and records): no checkpoint after phase 1, a failing
  phase 2, drift, no ``val/`` record, each with the root's message and
  exit code 1; a flat run ends in ``SOAK OK``.
* A scaled-down soak of ``configs/multi/MTL_tiny_synthetic_devaug.py``
  through ``soak`` on the CPU, both legs in child processes of the port's
  train tool: 8 iterations, eval every 4, a log record every 2, SIGTERM
  once the first record exists; the preemption checkpoint strictly inside
  the run, ``--auto-resume`` from it to the end, the records' steps
  continuing from it, an eval record, the summary's numbers.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from rscotr_tpu_torch.tools import soak_flagship as sf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tools", "soak_flagship.sh")
TINY = "configs/multi/MTL_tiny_synthetic_devaug.py"
TINY_ITERS = 8
TINY_OPTIONS = ("evaluation.interval=4", "checkpoint_config.interval=100000",
                "log_config.interval=2")
# the legs' train tool on 2 threads (the suite's workers share the cores)
# and with tensorflow kept out: torch's TensorBoard writer imports it when
# it is installed (seconds a process); without it the writer takes
# tensorboard's own stub, as on a host without tensorflow
TRAIN_NO_TF = [sys.executable, "-c",
               "import os, runpy, sys; os.environ['OMP_NUM_THREADS'] = '2'; "
               "sys.modules['tensorflow'] = None; import torch; "
               "torch.set_num_threads(2); "
               "runpy.run_module('rscotr_tpu_torch.tools.train', "
               "run_name='__main__', alter_sys=True)"]


def root_summary_code() -> str:
    """The heredoc of the root script: its summary in Python."""
    with open(SCRIPT) as f:
        text = f.read()
    m = re.search(r"<<'EOF'\n(.*?)\nEOF\n", text, re.S)
    assert m, "the root script's summary heredoc"
    return m.group(1)


def root_messages() -> set:
    with open(SCRIPT) as f:
        return set(re.findall(r"SOAK FAIL: [^\"$]+", f.read()))


def run_root(wd, resumed_from, iters):
    """The root's summary as the script runs it: (stdout lines, rc, the
    last stderr line)."""
    r = subprocess.run([sys.executable, "-", wd, str(resumed_from),
                        str(iters)], input=root_summary_code(),
                       capture_output=True, text=True, timeout=60)
    err = r.stderr.strip().splitlines()
    return r.stdout.splitlines(), r.returncode, err[-1] if err else ""


def root_numbers(wd, resumed_from, iters, monkeypatch):
    """The root summary's variables, its code executed in a namespace."""
    ns = {"__name__": "__soak__"}
    monkeypatch.setattr(sys, "argv", ["-", wd, str(resumed_from),
                                      str(iters)])
    try:
        exec(compile(root_summary_code(), SCRIPT, "exec"), ns)
    except AssertionError:
        pass
    return ns


def write_records(wd, times, evals=(), interval=16, blank=False):
    """A ``metrics.jsonl`` as the log hook writes it: a record each
    ``interval`` steps, tasks in groups of one record, ``val/`` keys at the
    steps in ``evals``."""
    os.makedirs(wd, exist_ok=True)
    with open(os.path.join(wd, "metrics.jsonl"), "w") as f:
        for i, t in enumerate(times):
            step = interval * (i + 1)
            task = sf.TASKS[i % 3]
            rec = {"step": step, "time": float(t),
                   f"{task}.set.loss": 1.0 / (i + 1), "grad_norm": 1.0,
                   "data_time": 1e-4}
            if step in evals:
                rec.update({"val/set.metric": 0.5, "val/set.other": 0.1})
            f.write(json.dumps(rec) + "\n")
            if blank and i == 3:
                f.write("\n")


def synthetic_run(wd, kind, n=63, seed=0):
    rng = np.random.default_rng(seed)
    base = np.tile([0.08, 0.27, 0.21], n)[:n] * \
        (1 + 0.02 * rng.standard_normal(n))
    if kind == "drift":
        base[n // 2:] *= 1.2
    evals = () if kind == "noeval" else (n * 16,)
    write_records(wd, base, evals=evals, blank=kind == "flat")
    return 780, 1000


def tiny_soak(wd):
    """The scaled-down soak: SIGTERM once phase 1's first record is
    written."""
    metrics = os.path.join(wd, "metrics.jsonl")
    lines = []
    res = sf.soak(wd, TINY_ITERS, None, device="cpu", cfg=TINY,
                  cfg_options=TINY_OPTIONS,
                  kill_when=lambda: os.path.exists(metrics)
                  and os.path.getsize(metrics) > 0,
                  command=TRAIN_NO_TF, grace_s=120, out=lines.append)
    return res, lines


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("soak") / "wd")
    res, lines = tiny_soak(wd)
    return wd, res, lines


# -- (c) the scaled-down soak ------------------------------------------------

def test_tiny_soak_preempts_and_resumes(tiny):
    wd, res, lines = tiny
    assert res["rc"] == 0, lines
    first, second = res["legs"]
    n = res["resumed_from"]
    assert first.killed and first.rc == sf.TIMEOUT_RC
    assert 0 < n < TINY_ITERS, lines
    assert second.rc == 0 and not second.killed
    assert f"checkpoint after preemption: iter_{n}" in lines
    assert os.path.isfile(os.path.join(wd, f"iter_{n}.pth"))
    assert os.path.isfile(os.path.join(wd, f"iter_{TINY_ITERS}.pth"))
    with open(os.path.join(wd, "train.log")) as f:
        log = f.read()
    assert f"preemption checkpoint @ iter {n}" in log
    assert f"resumed from {os.path.join(wd, f'iter_{n}.pth')} @ iter {n}" \
        in log
    assert f"start training: iter {n} -> {TINY_ITERS}" in log
    # the records' steps: phase 1's up to n, then phase 2's after it, each
    # log step once and in order, to the end
    steps = [r["step"] for r in sf.read_records(wd)]
    assert steps == list(range(2, TINY_ITERS + 1, 2))
    # an eval record, every number of the summary finite
    s, d = res["summary"], res["details"]
    assert s["evals"] >= 1 and TINY_ITERS in s["eval_steps"]
    assert s["n"] == len(steps) and s["resumed_from"] == n
    assert all(math.isfinite(s[k]) for k in ("mid", "late", "drift"))
    assert [st for st, _ in d["evals"]] == [4, 8] == s["eval_steps"]
    assert all(sec > 0 for _, sec in d["evals"])
    for leg in (first, second):
        assert leg.peak("gpu_mib") is None   # --device cpu: no card sampled
        assert leg.peak("rss_mib") > 0
    rss = second.track("rss_mib")
    assert len(rss) == 5 and max(rss) <= second.peak("rss_mib")
    with open(os.path.join(wd, "soak_samples.jsonl")) as f:
        phases = [json.loads(x)["phase"] for x in f]
    assert phases == [1] * len(first.samples) + [2] * len(second.samples)
    # the quarters' means: each record's time by the steps it covers (the
    # first of phase 2 from n)
    recs = sf.read_records(wd)
    prev, k = 0, []
    for r in recs:
        k.append(r["step"] - (n if prev < n < r["step"] else prev))
        prev = r["step"]
    m = len(recs)
    for q in range(4):
        a, b = q * m // 4, (q + 1) * m // 4
        want = sum(r["time"] * j for r, j in zip(recs[a:b], k[a:b])) / \
            sum(k[a:b])
        assert d["means"][q] == pytest.approx(want, rel=1e-12)
    assert lines[-5].startswith("soak: ") and lines[-1].startswith(
        "soak: eval records at iters")


def test_resume_keeps_no_host_copy_of_its_checkpoint(tiny, tmp_path,
                                                      monkeypatch):
    """The flagship soak's phase 2 held 0.5-1.0 GiB more host memory than
    its phase 1 at the same points (an H100 host): ``train_model`` kept the
    resumed checkpoint's CPU tensors (weights and moments) for the whole
    run. Nothing of them may outlive
    the loading: weak references to every tensor the load returned are dead
    when the runner starts."""
    import shutil

    from rscotr_tpu_torch import apis
    from rscotr_tpu_torch.data import load_data_cfg
    from rscotr_tpu_torch.engine import checkpoint as ck
    from rscotr_tpu_torch.engine.hooks import Hook
    from rscotr_tpu_torch.utils.config import load_cfg

    if "tensorflow" not in sys.modules:   # see TRAIN_NO_TF
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    wd, _, _ = tiny
    work = tmp_path / "resume"
    work.mkdir()
    shutil.copy(os.path.join(wd, f"iter_{TINY_ITERS}.pth"), work)
    refs, real = [], ck.load_checkpoint

    def spy(*a, **kw):
        out = real(*a, **kw)
        refs.extend(weakref.ref(t) for t in [
            *out["state_dict"].values(), *out["optimizer"]["mu"].values(),
            *out["optimizer"]["nu"].values()])
        return out

    alive = []

    class Probe(Hook):
        def before_run(self, runner):
            gc.collect()
            alive.append(sum(r() is not None for r in refs))

    monkeypatch.setattr(ck, "load_checkpoint", spy)
    path = os.path.join(ROOT, TINY)
    cfg = load_data_cfg(load_cfg(path), config_root=ROOT, filename=path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        runner = apis.train_model(
            cfg, str(work), validate=False, auto_resume=True,
            max_iters_override=TINY_ITERS + 1, device="cpu",
            hooks=[Probe()])
    finally:
        torch.set_num_threads(threads)
    assert runner.step == TINY_ITERS + 1
    assert len(refs) > 100 and alive == [0]


# -- (a) summary parity -------------------------------------------------------

@pytest.mark.parametrize("kind", ["flat", "drift", "noeval", "tiny"])
def test_summary_matches_root(kind, tiny, tmp_path, monkeypatch):
    if kind == "tiny":
        wd, res, _ = tiny
        last, iters = res["resumed_from"], TINY_ITERS
    else:
        wd = str(tmp_path / kind)
        last, iters = synthetic_run(wd, kind)
    want, rc, err = run_root(wd, last, iters)
    got = []
    summary = sf.summarize(wd, last, iters, out=got.append)
    try:
        sf.check(summary)
        failed = None
        got.append("SOAK OK")   # the CLI's last line
    except AssertionError as e:
        failed = str(e)
    assert got == want
    ns = root_numbers(wd, last, iters, monkeypatch)
    assert (summary["n"], summary["mid"], summary["late"], summary["drift"],
            summary["evals"]) == (ns["n"], ns["ma"], ns["mb"], ns["drift"],
                                  len(ns["evals"]))
    if kind == "flat":
        assert rc == 0 and failed is None
    elif kind in ("drift", "noeval"):
        assert rc == 1 and err == f"AssertionError: {failed}"
        assert failed in root_messages()
    else:   # the tiny run: its verdict is the root's, whatever it is
        assert (rc == 0) == (failed is None)
        assert failed is None or err == f"AssertionError: {failed}"


def test_latest_iter_reads_the_digits(tmp_path):
    for f in ("iter_96.pth", "iter_780.pth", "iter_1000.pth.tmp",
              "best_checkpoint.pth", "last_checkpoint"):
        (tmp_path / f).write_text("")
    (tmp_path / "iter_900").mkdir()   # the JAX package's layout: not ours
    assert sf.latest_iter(str(tmp_path)) == 780
    assert sf.latest_iter(str(tmp_path / "none")) is None


# -- (b) the CLI's failure paths ---------------------------------------------

# a stand-in for the train tool: argv = mode, then a leg's arguments
FAKE = r"""
import json, os, signal, sys, time
mode, argv = sys.argv[1], sys.argv[2:]
wd = argv[argv.index("--work-dir") + 1]
iters = int(argv[argv.index("--max-iters") + 1])
resume = "--auto-resume" in argv

def records(steps, t, val_at=None):
    with open(os.path.join(wd, "metrics.jsonl"), "a") as f:
        for s in steps:
            rec = {"step": s, "time": t * (1 + 0.01 * (s % 3)),
                   "cls.set.loss": 1.0}
            if s == val_at and mode != "noval":
                rec["val/set.metric"] = 1.0
            f.write(json.dumps(rec) + "\n")

if mode == "nockpt":
    sys.exit(0)
if not resume:
    def term(*_):
        open(os.path.join(wd, "iter_40.pth"), "w").close()
        sys.exit(0)
    signal.signal(signal.SIGTERM, term)
    records(range(2, 41, 2), 0.2)
    time.sleep(60)
    sys.exit(5)
if mode == "resume_fails":
    sys.exit(3)
records(range(42, iters + 1, 2), 0.3 if mode == "drift" else 0.2,
        val_at=iters)
open(os.path.join(wd, f"iter_{iters}.pth"), "w").close()
"""

CLI = ("import sys; from rscotr_tpu_torch.tools import soak_flagship as s; "
       "s.train_command = lambda: [sys.executable, '-c', {fake!r}, {mode!r}]; "
       "sys.exit(s.main(sys.argv[1:]))")


@pytest.mark.parametrize("mode,message,tail", [pytest.param(*c, id=c[0])
                                               for c in [
    ("nockpt", "SOAK FAIL: no preemption checkpoint", None),
    ("resume_fails", "SOAK FAIL: resume leg rc=3", None),
    ("drift", None, "AssertionError: SOAK FAIL: steady-state step time "
                    "drifted"),
    ("noval", None, "AssertionError: SOAK FAIL: no eval records"),
    ("flat", None, None),
]])
def test_cli_failure_paths(mode, message, tail, tmp_path):
    wd = str(tmp_path / "wd")
    r = subprocess.run(
        [sys.executable, "-c", CLI.format(fake=FAKE, mode=mode), wd, "80",
         "1", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    out = r.stdout.splitlines()
    err = r.stderr.strip().splitlines()
    assert out[0] == "== phase 1: train with eval every 250, SIGTERM after " \
                     "1s =="
    if mode == "nockpt":
        assert "phase 1 rc=0 (124 = timeout fired, expected)" in out
        assert out[-2:] == ["checkpoint after preemption: iter_NONE",
                            message]
        assert r.returncode == 1 and message in root_messages()
        return
    assert "phase 1 rc=124 (124 = timeout fired, expected)" in out
    assert "checkpoint after preemption: iter_40" in out
    assert "== phase 2: auto-resume to 80 ==" in out
    if mode == "resume_fails":
        assert out[-3] == "phase 2 rc=3" and out[-1] == message
        assert r.returncode == 1 and "SOAK FAIL: resume leg rc=" in \
            root_messages()
        return
    assert "phase 2 rc=0" in out
    assert "soak: 40 time records; median s/iter mid=" in "\n".join(out)
    assert "soak: 1 eval records; resumed from iter 40" in out or \
        mode == "noval"
    if tail is None:
        assert r.returncode == 0 and out[-1] == "SOAK OK"
    else:
        assert r.returncode == 1 and err[-1] == tail
        assert "SOAK OK" not in out
        assert tail.split(": ", 1)[1] in root_messages()
