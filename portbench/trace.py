"""The traced window: ``torch.profiler`` over a steady run of requests,
reduced to what the per-layer metrics read.

The harness marks the window and each request with spans of its own
(``portbench.window``, ``portbench.request``); the device's operations
inside the window give the busy time (the union of their intervals), each
kernel's count and time, and the idle gaps, each labelled by the host
operation that was running at its middle (the innermost one; ``host``
where the host ran Python between operations).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

WINDOW = "portbench.window"
REQUEST = "portbench.request"


class TraceSummary(NamedTuple):
    """The traced window reduced: its length and the device's busy time
    (us), each device operation's launches and time by name (us), the
    idle gaps' time by what the host was doing (us), and the requests the
    window held."""

    window_us: float
    busy_us: float
    ops: Dict[str, Tuple[int, float]]
    gaps: Dict[str, float]
    requests: int


#: Host events of the profiler's own, which label no gap.
PROFILER_EVENTS = ("Activity Buffer Request",)


def _is_device(event) -> bool:
    kind = getattr(event, "device_type", None)
    return kind is not None and kind.name in ("CUDA", "PrivateUse1")


def _is_span(event) -> bool:
    """The harness's spans, which the profiler also lays on the device's
    timeline (as user annotations): no device work."""
    return event.name.startswith("portbench.")


def summarize(events) -> TraceSummary:
    """Reduce a profiler's ``events()`` to a ``TraceSummary``."""
    spans = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = spans[0].time_range.start
    w1 = spans[0].time_range.end
    requests = sum(1 for e in events
                   if e.name == REQUEST and not _is_device(e))
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if _is_device(e) and not _is_span(e)
                  and e.time_range.end > w0 and e.time_range.start < w1),
                 key=lambda x: x[0])
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        ops[name][0] += 1
        ops[name][1] += e - s
    # The union of the device's intervals, clipped to the window.
    merged: List[List[float]] = []
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    return TraceSummary(w1 - w0, busy, {k: (int(v[0]), v[1])
                                        for k, v in ops.items()},
                        _label_gaps(events, holes), requests)


def _label_gaps(events, holes) -> Dict[str, float]:
    """Each idle gap's time under the name of the innermost host operation
    running at its middle (``host`` where none ran), summed by name."""
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if not _is_device(e)
                   and not _is_span(e) and e.name not in PROFILER_EVENTS),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in sorted(holes):
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(starts, mid)
        active.extend(host[i:j])
        i = max(i, j)
        active = [a for a in active if a[1] >= mid]
        label = max(active, key=lambda a: a[0])[2] if active else "host"
        out[label] += e - s
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The n largest entries of {name: us} as [[name, seconds]]."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-6] for k, v in items]
