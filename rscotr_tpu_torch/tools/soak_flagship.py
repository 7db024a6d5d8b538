"""The soak on the card (PyTorch counterpart of the root
``tools/soak_flagship.sh``, with its steps, its lines and its checks): a
long run of the devaug flagship with periodic eval and save-best, a SIGTERM
mid-run, and an ``--auto-resume`` to the end. It holds the steady-state
step time to no drift and checks that the resume continued from the
preemption checkpoint.

    python -m rscotr_tpu_torch.tools.soak_flagship [WORK_DIR] \\
        [TOTAL_ITERS] [KILL_AFTER_S] [--device cuda|cpu]

Defaults: ``soak_wd`` in the temporary directory (``/tmp/soak_wd``), 1000
iterations, SIGTERM after 240 s of phase 1. Both legs run the port's train
tool (``python -m rscotr_tpu_torch.tools.train``) in a process of its own.
Phase 1 is stopped as ``timeout --signal=TERM`` stops it (the signal to the
leg's process group; rc 124 once it fired): the runner finishes the step
in flight, ``CheckpointHook`` writes ``iter_N.pth`` and the process exits
cleanly. Phase 2 resumes from it (``--auto-resume``). Then the root's
summary over
``WORK_DIR/metrics.jsonl``: the median s/iter of the records in
``times[n//4:n//2]`` against ``times[3n//4:]``, ``abs(drift) < 0.15`` and
at least one ``val/`` record, then ``SOAK OK``; a failed check raises
``AssertionError`` with the root's message (exit 1).

Beside the root's lines each leg prints its wall time, the card's peak
``memory.used`` (``nvidia-smi``, sampled each second beside the leg) and
the train process's RSS at its first log record and at its end; after the
summary, the per-task medians of the two windows and each eval's seconds
(``train.log``'s ``eval @ iter N in S s`` lines).

``soak`` runs the protocol with the config, the options, the signal
(``kill_after_s``, or ``kill_when``: a call polled while phase 1 runs) and
the leg's command as arguments; ``summarize`` and ``check`` are the root's
summary and asserts. Importing the module runs nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CFG = "configs/multi/MTL_synthetic_flagship_devaug.py"
CFG_OPTIONS = ("evaluation.interval=250",
               "checkpoint_config.interval=100000",
               "log_config.interval=16")
DRIFT_LIMIT = 0.15
TIMEOUT_RC = 124    # what ``timeout`` returns once its signal fired
TASKS = ("cls", "det", "seg")
_ITER_RE = re.compile(r"iter_(\d+)\.pth")
_EVAL_RE = re.compile(r"eval @ iter (\d+) in ([0-9.]+) s")


def say(line: str) -> None:
    print(line, flush=True)   # in order with the legs' own output


def train_command() -> List[str]:
    """The leg's command: the port's train tool in a fresh interpreter."""
    return [sys.executable, "-m", "rscotr_tpu_torch.tools.train"]


def leg_argv(cfg: str, work_dir: str, iters: int,
             cfg_options: Sequence[str], device: str,
             resume: bool = False) -> List[str]:
    """The train tool's arguments of one leg (the root's two calls)."""
    argv = [cfg, "--work-dir", work_dir, "--max-iters", str(iters)]
    if resume:
        argv.append("--auto-resume")
    return argv + ["--cfg-options", *cfg_options, "--device", device]


@dataclass
class Leg:
    """One leg's exit: ``rc`` as ``timeout`` gives it (124 once the signal
    fired), its wall seconds, and what was sampled beside it once a second
    (``samples``: ``t`` seconds into the leg, the process's ``rss_mib``
    (None or 0 once it has gone), the card's ``gpu_mib`` (None without a
    card) and ``records``, whether the leg had written a log record)."""
    rc: int
    killed: bool
    wall_s: float
    samples: List[dict] = field(default_factory=list)

    def track(self, key: str) -> List[float]:
        """``key`` at the leg's first log record, then a quarter, half,
        three quarters and all of the way through the samples after it
        (empty where none was taken)."""
        after = [x[key] for x in self.samples if x["records"] and x[key]]
        n = len(after) - 1
        return [after[round(q * n)] for q in (0, .25, .5, .75, 1)] \
            if after else []

    def peak(self, key: str) -> Optional[float]:
        vals = [x[key] for x in self.samples if x[key]]
        return max(vals) if vals else None


def _rss_mib(pid: int) -> Optional[float]:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return None


def _gpu_used_mib() -> Optional[float]:
    """``memory.used`` of the card the leg sees (the first one of
    ``CUDA_VISIBLE_DEVICES``, else 0), or None where nvidia-smi fails."""
    idx = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]
    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10)
        return float(r.stdout.split()[0]) if r.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


class _Sampler(threading.Thread):
    """Once a second while a leg runs: the process's RSS and, with
    ``gpu``, the card's ``memory.used``, and whether the leg's first log
    record is in ``metrics.jsonl`` (the file grew past ``base`` bytes)."""

    def __init__(self, pid: int, metrics: str, gpu: bool):
        super().__init__(daemon=True)
        self.pid, self.metrics, self.gpu = pid, metrics, gpu
        self.base = os.path.getsize(metrics) if os.path.exists(metrics) \
            else 0
        self.samples: List[dict] = []
        self.done = threading.Event()

    def run(self) -> None:
        t0 = time.perf_counter()
        while True:
            self.samples.append(dict(
                t=time.perf_counter() - t0, rss_mib=_rss_mib(self.pid),
                gpu_mib=_gpu_used_mib() if self.gpu else None,
                records=os.path.exists(self.metrics)
                and os.path.getsize(self.metrics) > self.base))
            if self.done.wait(1.0):
                return


def run_leg(argv: Sequence[str], work_dir: str,
            kill_after_s: Optional[float] = None,
            kill_when: Optional[Callable[[], bool]] = None,
            grace_s: Optional[float] = None,
            command: Optional[Sequence[str]] = None,
            gpu: bool = False) -> Leg:
    """Run one leg (``command`` + ``argv``) in a process group of its own
    and wait for it. Once ``kill_after_s`` seconds have passed or
    ``kill_when()`` is true, SIGTERM goes to the group, as ``timeout
    --signal=TERM`` sends it, and the rc is 124 whatever the process
    returns; ``grace_s`` after that a SIGKILL follows (``timeout -k``).
    The group is killed if the wait itself is cut."""
    cmd = [*(command or train_command()), *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True)
    sampler = _Sampler(proc.pid, os.path.join(work_dir, "metrics.jsonl"),
                       gpu)
    sampler.start()
    killed, t_kill = False, 0.0
    try:
        while proc.poll() is None:
            now = time.perf_counter()
            if not killed and (
                    (kill_after_s is not None and now - t0 >= kill_after_s)
                    or (kill_when is not None and kill_when())):
                os.killpg(proc.pid, signal.SIGTERM)
                killed, t_kill = True, now
            elif killed and grace_s is not None and now - t_kill > grace_s:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                break
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        sampler.done.set()
        sampler.join()
    return Leg(rc=TIMEOUT_RC if killed else proc.returncode, killed=killed,
               wall_s=time.perf_counter() - t0, samples=sampler.samples)


def latest_iter(work_dir: str) -> Optional[int]:
    """N of the newest ``iter_N.pth`` in the work dir (the root's ``ls -d
    iter_* | sort -n | tail -1``, read from the file name's digits), or
    None."""
    found = [int(m.group(1)) for f in (os.listdir(work_dir)
                                       if os.path.isdir(work_dir) else ())
             if (m := _ITER_RE.fullmatch(f))]
    return max(found) if found else None


def read_records(work_dir: str) -> List[dict]:
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(work_dir: str, resumed_from: int, iters: int,
              out: Callable[[str], None] = say) -> dict:
    """The root's summary (``tools/soak_flagship.sh``'s last block): its
    two lines through ``out``, and its numbers: ``n`` time records, the
    ``mid`` and ``late`` medians, ``drift``, ``evals`` (the records with a
    ``val/`` key), ``resumed_from`` and ``iters``."""
    recs = read_records(work_dir)
    times = [r["time"] for r in recs if "time" in r]
    evals = [r for r in recs if any(k.startswith("val/") for k in r)]
    n = len(times)
    ma = statistics.median(times[n // 4:n // 2])
    mb = statistics.median(times[3 * n // 4:])
    drift = (mb - ma) / ma
    out(f"soak: {n} time records; median s/iter "
        f"mid={ma:.3f} late={mb:.3f} drift={drift * 100:+.1f}%")
    out(f"soak: {len(evals)} eval records; resumed from iter "
        f"{resumed_from}")
    return dict(n=n, mid=ma, late=mb, drift=drift, evals=len(evals),
                eval_steps=[r.get("step") for r in evals],
                resumed_from=resumed_from, iters=iters)


def check(summary: dict) -> None:
    """The root's asserts on the summary, with its messages."""
    if not abs(summary["drift"]) < DRIFT_LIMIT:
        raise AssertionError("SOAK FAIL: steady-state step time drifted")
    if not summary["evals"]:
        raise AssertionError("SOAK FAIL: no eval records")


def record_task(rec: dict) -> Optional[str]:
    """The task of a log record: the prefix of its ``{task}.{dataset}.*``
    loss keys (the record holds the log vars of the step it was written
    at)."""
    for k in rec:
        task = k.split(".", 1)[0]
        if task in TASKS and "." in k:
            return task
    return None


def details(work_dir: str, resumed_from: Optional[int] = None) -> dict:
    """Beyond the root's summary: the mean s/iter of each quarter of the
    records (each record's ``time`` weighted by the steps it covers: those
    since the record before, or since the resume at ``resumed_from``; the
    second and the fourth are the summary's windows); per task, the median
    of the records of each window written at one of its steps (and their
    counts); the steps of the eval records; each eval's seconds from
    ``train.log``."""
    recs = [r for r in read_records(work_dir) if "time" in r]
    prev = 0
    for r in recs:
        if resumed_from is not None and prev < resumed_from < r["step"]:
            prev = resumed_from
        r["_steps"], prev = r["step"] - prev, r["step"]
    n = len(recs)
    windows = {"mid": recs[n // 4:n // 2], "late": recs[3 * n // 4:]}
    quarters = [recs[q * n // 4:(q + 1) * n // 4] for q in range(4)]
    means = [sum(r["time"] * r["_steps"] for r in rs)
             / sum(r["_steps"] for r in rs) for rs in quarters]
    tasks = {}
    for task in TASKS:
        tasks[task] = {}
        for w, rs in windows.items():
            ts = [r["time"] for r in rs if record_task(r) == task]
            tasks[task][w] = statistics.median(ts) if ts else None
            tasks[task][f"{w}_n"] = len(ts)
    evals = []
    log = os.path.join(work_dir, "train.log")
    if os.path.isfile(log):
        with open(log) as f:
            evals = [(int(m.group(1)), float(m.group(2)))
                     for m in map(_EVAL_RE.search, f) if m]
    return dict(means=means, tasks=tasks, evals=evals,
                eval_records=[r["step"] for r in recs
                              if any(k.startswith("val/") for k in r)])


def record_samples(work_dir: str, phase: int, leg: Leg) -> None:
    """A leg's samples to ``WORK_DIR/soak_samples.jsonl``, one a line."""
    with open(os.path.join(work_dir, "soak_samples.jsonl"), "a") as f:
        for x in leg.samples:
            f.write(json.dumps(dict(x, phase=phase)) + "\n")


def leg_line(name: str, leg: Leg) -> str:
    def track(key):
        vals = leg.track(key)
        return (" / ".join(f"{x:.0f}" for x in vals) + " MiB" if vals
                else "not sampled") + f", peak {leg.peak(key) or 0:.0f} MiB"
    card = ("card memory.used not sampled" if leg.peak("gpu_mib") is None
            else f"card memory.used (nvidia-smi) {track('gpu_mib')}")
    return (f"{name}: {leg.wall_s:.1f} s; train process RSS "
            f"{track('rss_mib')}; {card} (at its first log record, then a "
            "quarter, half, three quarters and all of the way through)")


def details_lines(d: dict) -> List[str]:
    def med(x):
        return "-" if x is None else f"{x:.3f}"
    m = d["means"]
    return [
        "soak: mean s/iter (records weighted by their steps) of each "
        "quarter of the records " + " / ".join(f"{x:.3f}" for x in m)
        + f"; late against mid {(m[3] / m[1] - 1) * 100:+.1f}%",
        "soak: median s/iter mid / late of the records written at a "
        "step of each task (records): " + ", ".join(
            f"{t} {med(r['mid'])} / {med(r['late'])} "
            f"({r['mid_n']} / {r['late_n']})" for t, r in d["tasks"].items()),
        f"soak: eval records at iters {d['eval_records']}; evals "
        + (", ".join(f"@ {s} {sec:.2f} s" for s, sec in d["evals"])
           or "none in train.log")]


def soak(work_dir: str, iters: int = 1000, kill_after_s: Optional[float]
         = 240, device: str = "cuda", cfg: str = CFG,
         cfg_options: Sequence[str] = CFG_OPTIONS,
         kill_when: Optional[Callable[[], bool]] = None,
         command: Optional[Sequence[str]] = None,
         grace_s: Optional[float] = None,
         out: Callable[[str], None] = say) -> dict:
    """The root script's steps up to its summary. Returns ``rc`` (1 where
    the root exits 1 before its summary, with its message printed, else
    0), the two ``legs``, ``resumed_from`` (N), the ``summary`` and the
    ``details``; the caller holds the summary to the root's checks
    (``check``)."""
    work_dir = os.path.abspath(work_dir)
    cfg = os.path.join(ROOT, cfg)
    gpu = device.startswith("cuda")
    interval = next((o.split("=", 1)[1] for o in cfg_options
                     if o.startswith("evaluation.interval=")), "?")
    res = dict(rc=1, legs=[], resumed_from=None, summary=None, details=None)

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    kill = "" if kill_after_s is None else f" after {kill_after_s:g}s"
    out(f"== phase 1: train with eval every {interval}, SIGTERM{kill} ==")
    leg = run_leg(leg_argv(cfg, work_dir, iters, cfg_options, device),
                  work_dir, kill_after_s=kill_after_s, kill_when=kill_when,
                  grace_s=grace_s, command=command, gpu=gpu)
    record_samples(work_dir, 1, leg)
    res["legs"].append(leg)
    out(f"phase 1 rc={leg.rc} (124 = timeout fired, expected)")
    out(leg_line("phase 1", leg))

    last = latest_iter(work_dir)
    out("checkpoint after preemption: iter_"
        + ("NONE" if last is None else str(last)))
    if last is None:
        out("SOAK FAIL: no preemption checkpoint")
        return res
    res["resumed_from"] = last

    out(f"== phase 2: auto-resume to {iters} ==")
    leg = run_leg(leg_argv(cfg, work_dir, iters, cfg_options, device,
                           resume=True), work_dir, grace_s=grace_s,
                  command=command, gpu=gpu)
    record_samples(work_dir, 2, leg)
    res["legs"].append(leg)
    out(f"phase 2 rc={leg.rc}")
    out(leg_line("phase 2", leg))
    if leg.rc != 0:
        out(f"SOAK FAIL: resume leg rc={leg.rc}")
        return res

    res["summary"] = summarize(work_dir, last, iters, out=out)
    res["details"] = details(work_dir, last)
    for line in details_lines(res["details"]):
        out(line)
    res["rc"] = 0
    return res


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Soak: a long devaug flagship run, SIGTERM mid-run, "
                    "--auto-resume to the end, no step-time drift")
    p.add_argument("work_dir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "soak_wd"))
    p.add_argument("total_iters", nargs="?", type=int, default=1000)
    p.add_argument("kill_after_s", nargs="?", type=float, default=240)
    p.add_argument("--device", default="cuda",
                   help="where the legs train (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """The CLI: 1 where the root exits 1 before its summary; a failed
    summary check raises ``AssertionError`` (exit 1), as the root's
    asserts do; else ``SOAK OK`` and 0."""
    args = parse_args(argv)
    res = soak(args.work_dir, args.total_iters, args.kill_after_s,
               device=args.device)
    if res["rc"]:
        return res["rc"]
    check(res["summary"])
    say("SOAK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
