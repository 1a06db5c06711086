"""Phase tracer for the closed-loop drivers (the port of
``repro.obs.trace``).

The chunk loop of ``txn/executor.FusedExecutor.run*`` and the audit in
``txn/drivers.run_loop`` wrap each phase (``megastep``, ``outbox-drain``,
``share-refresh``, ``audit``) in :meth:`PhaseTracer.span`, which opens a
``torch.profiler.record_function`` range (visible in a ``torch.profiler``
trace when one is recording) and accumulates host wall clocks per phase.

CUDA work is queued asynchronously, so a span around a graph replay
measures how long the host takes to enqueue it, as the reference's spans
measure dispatch time. ``sync=True`` makes the caller wait for the card
at the end of each span (:meth:`maybe_sync`), which gives each phase its
device time at the cost of one synchronisation a phase: a measurement
mode, never the default. No span is opened inside a graph capture.

Snapshots are plain dicts (JSON-ready); :meth:`dashboard` renders the text
view ``launch/tpcc_serve.py`` prints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import torch


@dataclasses.dataclass
class PhaseStat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
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

    @contextlib.contextmanager
    def span(self, phase: str):
        if not self.enabled:
            yield self
            return
        with torch.profiler.record_function(phase):
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                self.phases.setdefault(phase, PhaseStat()).record(
                    time.perf_counter() - t0)

    def maybe_sync(self, value):
        """Wait for the card iff the tracer is in sync mode and ``value``
        lives on a CUDA device; callers put this at the end of a span to
        give the phase its device time."""
        if self.enabled and self.sync:
            t = _first_tensor(value)
            if t is not None and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
        return value

    def record(self, phase: str, seconds: float) -> None:
        """Record an interval timed elsewhere."""
        if self.enabled:
            self.phases.setdefault(phase, PhaseStat()).record(seconds)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        total = sum(p.total_s for p in self.phases.values()) or 1.0
        return {
            "sync": self.sync,
            "phases": {
                name: {
                    "count": p.count,
                    "total_s": p.total_s,
                    "mean_s": p.total_s / p.count if p.count else 0.0,
                    "min_s": 0.0 if p.min_s == float("inf") else p.min_s,
                    "max_s": p.max_s,
                    "share": p.total_s / total,
                }
                for name, p in self.phases.items()
            },
        }

    def dashboard(self) -> str:
        snap = self.snapshot()
        mode = "device-synced" if self.sync else "dispatch-side"
        lines = [f"phase breakdown ({mode} wall clocks):",
                 f"  {'phase':<16}{'calls':>7}{'total':>11}{'mean':>11}"
                 f"{'share':>8}"]
        for name, p in snap["phases"].items():
            lines.append(
                f"  {name:<16}{p['count']:>7}{p['total_s'] * 1e3:>9.1f}ms"
                f"{p['mean_s'] * 1e6:>9.0f}us{p['share']:>7.1%}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2)
