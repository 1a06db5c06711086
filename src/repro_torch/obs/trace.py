"""Phase tracer for the closed-loop drivers (the port of
``repro.obs.trace``).

The chunk loop of ``txn/executor.FusedExecutor.run*`` and the audit in
``txn/drivers.run_loop`` wrap each phase (``megastep``, ``outbox-drain``,
``share-refresh``, ``audit``) in :meth:`PhaseTracer.span`, which opens a
``torch.profiler.record_function`` range (visible in a ``torch.profiler``
trace when one is recording) and accumulates host wall clocks per phase.
On the card the executor also spans its call's set-up and close
(``call-setup`` and its steps, ``call-close``), which the JAX package has
not.

Spans nest: each phase keeps its parent, the span open around it, and
its self time, its wall clock less its children's. A phase keeps one
parent: opening it under another raises. Shares are taken over self
time, so they sum to 1 however deep the spans nest.

CUDA work is queued asynchronously, so a span around a graph replay
measures how long the host takes to enqueue it, as the reference's spans
measure dispatch time. ``sync=True`` makes the caller wait for the card
at the end of each span (:meth:`maybe_sync`), which gives each phase its
device time at the cost of one synchronisation a phase: a measurement
mode, never the default. No span is opened inside a graph capture.

Snapshots are plain dicts (JSON-ready); :meth:`dashboard` renders the text
view ``launch/tpcc_serve.py`` prints, each child indented under its
parent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class PhaseStat:
    parent: str | None = None
    count: int = 0
    total_s: float = 0.0
    self_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt: float, inner: float) -> None:
        """One span of ``dt`` seconds, ``inner`` of them in its children."""
        self.count += 1
        self.total_s += dt
        self.self_s += dt - inner
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


def _first_tensor(value):
    """The first tensor in ``value`` (a tensor or nested tuples of them)."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (tuple, list)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class PhaseTracer:
    """Accumulating per-phase wall clocks and profiler ranges."""

    def __init__(self, enabled: bool = True, sync: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.phases: dict[str, PhaseStat] = {}
        self._stack: list[list] = []   # open spans: [phase, children's s]

    @contextlib.contextmanager
    def span(self, phase: str):
        if not self.enabled:
            yield self
            return
        stack = self._stack
        parent = stack[-1][0] if stack else None
        known = self.phases.get(phase)
        if known is not None and known.parent != parent:
            raise ValueError(f"span {phase!r} opened under {parent!r}, "
                             f"earlier under {known.parent!r}")
        frame = [phase, 0.0]
        with torch.profiler.record_function(phase):
            stack.append(frame)
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                dt = time.perf_counter() - t0
                stack.pop()
                if stack:
                    stack[-1][1] += dt
                self.phases.setdefault(phase, PhaseStat(parent)).record(
                    dt, frame[1])

    def maybe_sync(self, value):
        """Wait for the card iff the tracer is in sync mode and ``value``
        lives on a CUDA device; callers put this at the end of a span to
        give the phase its device time."""
        if self.enabled and self.sync:
            t = _first_tensor(value)
            if t is not None and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
        return value

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        total = sum(p.self_s for p in self.phases.values()) or 1.0
        return {
            "sync": self.sync,
            "phases": {
                name: {
                    "parent": p.parent,
                    "count": p.count,
                    "total_s": p.total_s,
                    "self_s": p.self_s,
                    "mean_s": p.total_s / p.count if p.count else 0.0,
                    "min_s": 0.0 if p.min_s == float("inf") else p.min_s,
                    "max_s": p.max_s,
                    "share": p.self_s / total,
                }
                for name, p in self.phases.items()
            },
        }

    def _tree(self) -> list[tuple[int, str]]:
        """(depth, phase), each phase's children after it, depth first; a
        phase whose parent has not closed yet is a root."""
        kids: dict = {}
        for name, p in self.phases.items():
            up = p.parent if p.parent in self.phases else None
            kids.setdefault(up, []).append(name)
        out = []

        def walk(parent, depth):
            for name in kids.get(parent, []):
                out.append((depth, name))
                walk(name, depth + 1)
        walk(None, 0)
        return out

    def dashboard(self) -> str:
        phases = self.snapshot()["phases"]
        rows = [("  " * d + name, phases[name]) for d, name in self._tree()]
        w = max([16] + [len(label) + 1 for label, _ in rows])
        mode = "device-synced" if self.sync else "dispatch-side"
        lines = [f"phase breakdown ({mode} wall clocks):",
                 f"  {'phase':<{w}}{'calls':>7}{'total':>11}{'mean':>11}"
                 f"{'share':>8}"]
        for label, p in rows:
            lines.append(
                f"  {label:<{w}}{p['count']:>7}{p['total_s'] * 1e3:>9.1f}ms"
                f"{p['mean_s'] * 1e6:>9.0f}us{p['share']:>7.1%}")
        return "\n".join(lines)
