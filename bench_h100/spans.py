"""The program's stage spans in a traced sub-window: where the device's
idle time falls by stage, and what the host does inside a request.

The program marks its serving stages with host ranges named ``rscotr.*``
(``rscotr_tpu_torch/utils/trace.py``), which the profiler records on the
clock of the device trace; ``trace.read`` keeps them in ``Trace.host``
with every other host event. Spans of one request nest on the host
thread under its ``rscotr.request.*`` span. The idle intervals are the
complement of the union of the device intervals inside the window; each
idle stretch belongs to the innermost span the host is in, so a stage
counts its self time only. A trace with none of the program's spans (a
program without them) gives None, and the metric is left out.

A per-layer metric that reads a program stage takes its spans from
``run.trace.host`` through this module. The program's spans must be
``cpu_op``s (``torch._C._profiler._RecordFunctionFast``): the profiler
copies a ``record_function`` annotation onto the device timeline, where
``trace.read`` would count it as device work.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

PREFIX = "rscotr."
REQUEST = "rscotr.request."
INPUT = "rscotr.input"
# host calls that wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")

Span = Tuple[float, float, str]


def spans(trace) -> List[Span]:
    """The program's spans of the trace, by start."""
    return sorted(s for s in trace.host if s[2].startswith(PREFIX))


def idle(trace) -> List[Tuple[float, float]]:
    """The window's stretches with no device work, in order."""
    out, t = [], trace.start
    for a, b in sorted((a, b) for a, b, _ in trace.device):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def self_parts(nested: List[Span]) -> List[Span]:
    """What of each span no child span covers, as (start, end, name). The
    spans nest (one host thread; the window opens before the first traced
    request and closes after the last)."""
    nodes, stack = [], []
    for a, b, n in sorted(nested, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        node = (a, b, n, [])
        if stack:
            stack[-1][3].append((a, b))
        stack.append(node)
        nodes.append(node)
    out = []
    for a, b, n, kids in nodes:
        for x, y in kids:
            if x > a:
                out.append((a, x, n))
            a = max(a, y)
        if b > a:
            out.append((a, b, n))
    return out


def idle_by_stage(trace) -> Optional[Dict[str, float]]:
    """{span name: idle seconds while it is the host's innermost span};
    None when the trace has none of the program's spans."""
    sp = spans(trace)
    if not sp:
        return None
    gaps = idle(trace)
    ends = [g[1] for g in gaps]
    out = {n: 0.0 for _, _, n in sp}
    for a, b, n in self_parts(sp):
        k = bisect.bisect_right(ends, a)
        while k < len(gaps) and gaps[k][0] < b:
            out[n] += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    return out


def _traced(run):
    """(trace, its request spans), or None without a request span."""
    tr = run.trace if run.kind == "infer" else None
    reqs = [s for s in spans(tr) if s[2].startswith(REQUEST)] if tr else []
    return (tr, reqs) if reqs else None


def stage_idle_ms(run, names) -> Optional[float]:
    """Device-idle ms a traced request while the host's innermost span is
    one of ``names``."""
    got = _traced(run)
    if got is None:
        return None
    tr, reqs = got
    by = idle_by_stage(tr)
    return 1e3 * sum(by.get(n, 0.0) for n in names) / len(reqs)


def input_ms(run) -> Optional[float]:
    """Host ms a traced request inside ``rscotr.input``."""
    got = _traced(run)
    if got is None:
        return None
    tr, reqs = got
    return 1e3 * sum(b - a for a, b, n in spans(tr) if n == INPUT) / len(reqs)


def host_syncs(run) -> Optional[float]:
    """Host synchronisations with the card a traced request, inside its
    request span (the harness's read-back after the entry returns is not)."""
    got = _traced(run)
    if got is None:
        return None
    tr, reqs = got
    starts = [a for a, _, _ in reqs]
    count = 0
    for a, b, n in tr.host:
        if not n.startswith(SYNCS):
            continue
        k = bisect.bisect_right(starts, a) - 1
        count += k >= 0 and b <= reqs[k][1]
    return count / len(reqs)
