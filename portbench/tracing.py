"""Reading a ``torch.profiler`` trace of the traced passes.

The traced window is each pass's "portbench.pass" range: the executor
call that the benchmark's clock times, from its set-up and captures to
its closing synchronise. Device activity (kernels, copies, fills) inside
those windows gives the busy time, the time of each kernel by name, and
the idle gaps, each named by the executor's span open on the host when it
began, or as the call's set-up before its first "megastep" span.
"""

from __future__ import annotations

import dataclasses

PHASES = ("megastep", "outbox-drain", "share-refresh")
PASS = "portbench.pass"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict        # kernel name -> device seconds inside the windows
    idle_gaps: list       # [[host phase, seconds], ...] longest first
    n_device_events: int


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _intervals(events):
    out = []
    for e in events:
        start = _ns(e, "start")
        out.append((start, start + _ns(e, "duration"), e.name()))
    return out


def _union(spans):
    merged = []
    for a, b in sorted((a, b) for a, b, *_ in spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi), *rest) for a, b, *rest in spans
            if b > lo and a < hi]


def _annotation(e) -> bool:
    """A ``record_function`` range the profiler mirrors onto the device's
    timeline: no device work."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else e.name() in PHASES + (PASS,)


def summarize(prof) -> TraceSummary:
    events = list(prof.profiler.kineto_results.events())
    on_dev = [str(e.device_type()).endswith("CUDA") for e in events]
    dev = [e for e, d in zip(events, on_dev)
           if d and not _annotation(e) and e.name() not in PHASES + (PASS,)]
    cpu = [e for e, d in zip(events, on_dev) if not d]
    passes = _intervals(e for e in cpu if e.name() == PASS)
    phases = _intervals(e for e in cpu if e.name() in PHASES)
    device = _intervals(dev)
    window_ns = busy_ns = 0
    kernel_ns: dict = {}
    gaps: dict = {}
    for lo, hi, _ in passes:
        first = min((a for a, b, n in phases
                     if n == "megastep" and lo <= a < hi), default=hi)
        window_ns += hi - lo
        inside = _clip(device, lo, hi)
        busy = _union(inside)
        busy_ns += sum(b - a for a, b in busy)
        for a, b, name in inside:
            kernel_ns[name] = kernel_ns.get(name, 0) + (b - a)
        edge = lo
        for a, b in busy + [[hi, hi]]:
            if a > edge:
                open_ = [n for p0, p1, n in phases if p0 <= edge < p1]
                label = (open_[-1] if open_ else "between phases"
                         if edge >= first else "call set-up and capture")
                g = gaps.setdefault(label, [0, 0])
                g[0] += a - edge
                g[1] += 1
            edge = max(edge, b)
    idle = sorted(([f"{k} ({n} gaps)", ns * 1e-9] for k, (ns, n)
                   in gaps.items()), key=lambda x: -x[1])
    return TraceSummary(window_ns * 1e-9, busy_ns * 1e-9,
                        {k: v * 1e-9 for k, v in kernel_ns.items()},
                        idle[:10], len(device))


def kernel_seconds(summary: TraceSummary, name: str) -> float:
    """Device seconds of the kernels whose name holds ``name``."""
    return sum(v for k, v in summary.kernel_s.items() if name in k)


def top_ops(summary: TraceSummary, n: int = 10) -> list:
    ops = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:120], v] for k, v in ops]
