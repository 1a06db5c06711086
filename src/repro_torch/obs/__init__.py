"""The coordination-free observability plane (the port of ``repro.obs``).

Three pillars, one session object:

* :mod:`repro_torch.obs.metrics` — the on-device metrics lattice
  (per-type latency-proxy histograms, per-replica abort and cold-reject
  counters, the item-access profile), fed after the fused executor's
  timed loop from the chunks it ran; the lattice joins commute, so that
  equals recording inline, and the loop launches nothing more;
* :mod:`repro_torch.obs.trace` — the phase tracer (span wall clocks and
  ``torch.profiler.record_function`` ranges around megastep,
  outbox-drain, share-refresh and audit, and on the card around the
  fused executor's call set-up and close; spans nest);
* :mod:`repro_torch.obs.ledger` — the coordination ledger (per-phase
  collective calls and bytes on the wire, counted by
  ``txn.collectives.counted()``; hot phases budgeted at zero).

:class:`ObsSession` bundles them for the closed-loop drivers: pass one to
``txn.drivers.run_loop(obs=...)`` and read ``session.snapshot()`` after
the run. The snapshot's schema, ``"repro.obs/1"``, and its keys are the
reference's, so a reader of one package's JSON reads the other's.
"""

from __future__ import annotations

import json

import numpy as np

from .ledger import CoordinationLedger, build_ledger
from .metrics import (N_TXN_TYPES, OBS_BINS, TXN_TYPES, ObsMetrics,
                      add_cold_rejects, fold_counters,
                      heartbeat_lag_histogram, heartbeat_lag_summary,
                      histogram_quantile, init_obs_metrics,
                      item_access_summary, latency_summary, make_obs_metrics,
                      metrics_to_host, obs_metrics_join, record_chunk)
from .trace import PhaseTracer

__all__ = [
    "ObsSession", "PhaseTracer", "CoordinationLedger", "build_ledger",
    "ObsMetrics", "make_obs_metrics", "init_obs_metrics", "obs_metrics_join",
    "record_chunk", "fold_counters", "add_cold_rejects", "metrics_to_host",
    "histogram_quantile", "latency_summary", "item_access_summary",
    "heartbeat_lag_histogram", "heartbeat_lag_summary", "TXN_TYPES",
    "N_TXN_TYPES", "OBS_BINS",
]


class ObsSession:
    """One closed-loop run's observability state.

    ``metrics=True`` feeds the on-device :class:`ObsMetrics` lattice from
    the fused executor's run (write-only: the transaction path never reads
    it, so the final state is bit-equal to a metrics-off run);
    ``sync_spans=True`` waits for the card at the end of each tracer span,
    which gives each phase its device time (a measurement mode: it changes
    timing, never results); ``ledger=True`` builds the coordination ledger
    at finish, outside every timed region.
    """

    def __init__(self, metrics: bool = True, trace: bool = True,
                 sync_spans: bool = False, ledger: bool = False):
        self.wants_metrics = metrics
        self.wants_ledger = ledger
        self.tracer = PhaseTracer(enabled=trace, sync=sync_spans)
        self.device_metrics: ObsMetrics | None = None
        self.metrics: ObsMetrics | None = None   # host copy, set at finish
        self.heartbeat_lag = None                # HistogramLattice | None
        self.ledger: CoordinationLedger | None = None
        self.stats = None
        self._engine = None
        self._run_kw: dict = {}
        self._total_steps: int | None = None

    # -- driver-side hooks ---------------------------------------------------

    def span(self, phase: str):
        return self.tracer.span(phase)

    def maybe_sync(self, value):
        return self.tracer.maybe_sync(value)

    def init_metrics(self, engine) -> ObsMetrics | None:
        """Called by the executor at the start of a run: the lattice it
        feeds (None when metrics are off)."""
        self._engine = engine
        if not self.wants_metrics:
            return None
        self.device_metrics = init_obs_metrics(engine)
        return self.device_metrics

    def finish(self, engine, stats, *, total_steps: int | None = None,
               ledger_kw: dict | None = None) -> None:
        """One device-to-host copy of the metrics lattice, and the ledger
        when the session wants one. ``total_steps`` (the steps the run
        executed) converts the latency proxy's steps to seconds with the
        run's wall time."""
        self._engine = engine
        self.stats = stats
        self._run_kw = dict(ledger_kw or {})
        self._total_steps = total_steps
        if self.device_metrics is not None:
            self.metrics = metrics_to_host(self.device_metrics)
        if self.wants_ledger:
            self.ledger = build_ledger(engine, **self._run_kw)

    # -- export --------------------------------------------------------------

    @property
    def step_wall_s(self) -> float | None:
        """Measured wall seconds a step (the drains' share included: the
        number a client sees)."""
        wall = getattr(self.stats, "wall_seconds", None)
        if wall and self._total_steps:
            return wall / self._total_steps
        return None

    def latency_summary(self) -> dict | None:
        if self.metrics is None:
            return None
        return latency_summary(self.metrics, self.step_wall_s)

    def item_access_summary(self, top_k: int = 10) -> dict | None:
        if self.metrics is None:
            return None
        return item_access_summary(self.metrics, top_k)

    def record_heartbeat_lags(self, lags) -> None:
        """Fold detection-latency samples (``LeaseMonitor.detection_lags``,
        in drain windows) into the session's heartbeat-lag histogram.
        Repeated records add to this session's lane; views from distinct
        observers merge by ``HistogramLattice.join`` over their lanes."""
        hist = heartbeat_lag_histogram(lags)
        self.heartbeat_lag = hist if self.heartbeat_lag is None else \
            self.heartbeat_lag._replace(
                counts=self.heartbeat_lag.counts + hist.counts)

    def detection_latency_summary(self) -> dict | None:
        if self.heartbeat_lag is None:
            return None
        return heartbeat_lag_summary(self.heartbeat_lag)

    def snapshot(self) -> dict:
        """The JSON-ready snapshot: closed-loop stats, per-type latency
        quantiles, counters, item-access profile, phase spans and the
        coordination ledger."""
        snap: dict = {"schema": "repro.obs/1"}
        if self.stats is not None:
            s = self.stats
            snap["stats"] = {f: getattr(s, f) for f in
                             s.__dataclass_fields__}
            snap["stats"]["committed"] = s.committed
            snap["stats"]["throughput"] = s.throughput
        if self.step_wall_s is not None:
            snap["step_wall_s"] = self.step_wall_s
        if self.metrics is not None:
            snap["latency"] = self.latency_summary()
            snap["counters"] = {
                "aborts_per_replica":
                    np.asarray(self.metrics.aborts.slots).tolist(),
                "cold_rejects_per_replica":
                    np.asarray(self.metrics.cold_rejects.slots).tolist(),
            }
            snap["item_access"] = self.item_access_summary()
        if self.heartbeat_lag is not None:
            snap["detection_latency"] = self.detection_latency_summary()
        snap["spans"] = self.tracer.snapshot()
        if self.ledger is not None:
            snap["ledger"] = self.ledger.snapshot()
        return snap

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **{"indent": 2, **kw})

    def dashboard(self) -> str:
        """Text view: latency table, spans, ledger."""
        parts = []
        lat = self.latency_summary()
        if lat:
            sw = self.step_wall_s
            parts.append("per-transaction-type latency proxy"
                         + (" (measured steps → seconds)" if sw else
                            " (scan-step units)") + ":")
            parts.append(f"  {'txn type':<14}{'count':>9}{'p50':>10}"
                         f"{'p99':>10}")
            for name, row in lat.items():
                if sw:
                    p50 = f"{row['p50_s'] * 1e6:>8.0f}us"
                    p99 = f"{row['p99_s'] * 1e6:>8.0f}us"
                else:
                    p50 = f"{row['p50_steps']:>8.1f}st"
                    p99 = f"{row['p99_steps']:>8.1f}st"
                parts.append(f"  {name:<14}{row['count']:>9}{p50:>10}"
                             f"{p99:>10}")
        if self.tracer.phases:
            parts.append(self.tracer.dashboard())
        if self.ledger is not None:
            parts.append(self.ledger.table())
        return "\n".join(parts)
