"""Reading a ``torch.profiler`` trace of a sub-window of a run.

The traced requests run inside one ``record_function(WINDOW)`` span; the
device's kernels, copies and sets inside it are the intervals read here.
The busy time is the length of their UNION (a copy on a side stream that
overlaps a kernel counts once), the idle share what the union leaves of
the span. Kernel time by name sums each name's own intervals.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW = "bench_h100.window"


@dataclass
class Trace:
    start: float                       # seconds on the trace's clock
    end: float
    device: List[Tuple[float, float, str]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _ in self.device])

    def kernel_s(self, names) -> Optional[float]:
        """Summed time of the device operations whose name contains one of
        ``names``; None when none ran."""
        spans = [b - a for a, b, n in self.device
                 if any(s in n for s in names)]
        return sum(spans) if spans else None

    def top_ops(self, k: int = 10):
        tot = {}
        for a, b, n in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest stretches with no device work, each named by
        the innermost host operation running at its middle."""
        spans = sorted((a, b) for a, b, _ in self.device)
        gaps, t = [], self.start
        for a, b in spans:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(s, n) for s, e, n in self.host if s <= mid <= e]
            name = max(inner)[1] if inner else "(no host op)"
            out.append((name, b - a))
        return out


def union_length(spans) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(spans):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _ns(ev, which):
    fn = getattr(ev, which + "_ns", None)
    if fn is not None:
        return fn()
    return getattr(ev, which + "_us")() * 1000


def read(prof) -> Optional[Trace]:
    """The ``WINDOW`` span of a finished profile, clipped to it; None when
    the profile has no such span."""
    import torch
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        return None
    ws = _ns(win[0], "start") * 1e-9
    we = ws + win[0].duration_ns() * 1e-9
    tr = Trace(ws, we)
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        a = _ns(e, "start") * 1e-9
        b = a + e.duration_ns() * 1e-9
        if b <= ws or a >= we or e.name() == WINDOW:
            continue
        item = (max(a, ws), min(b, we), e.name())
        (tr.device if e.device_type() == cuda else tr.host).append(item)
    return tr


def profiler():
    """A profiler of the host and the card; the caller starts and stops it
    and marks its sub-window with ``torch.profiler.record_function(WINDOW)``."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
