"""The coordination ledger (the port of ``repro.obs.ledger``): the
zero-collective proof as a budget reported with every run.

The one-shot proofs (``Engine.prove_coordination_free``,
``FusedExecutor.prove_megastep_coordination_free``) say whether a phase
coordinates; the ledger says how much, per phase, in calls and bytes of
each collective kind. The reference parses them from compiled HLO; here
each phase runs once under ``txn.collectives.counted()``, which counts the
port's only two cross-shard operations as they are called
(``all-gather``: the bytes of its output; ``all-reduce``: the bytes of one
operand, as ``utils/hlo.py::total_bytes`` takes the larger of output and
operand). Hot phases (the fused chunk, the RAMP reads, the metrics
recorders) carry a budget of exactly zero, and
:meth:`CoordinationLedger.assert_budget` fails the run if one ever calls a
collective; drains and the escrow share refresh report their traffic,
weighted by cadence (a refresh every ``refresh_every`` drains counts
``1/refresh_every`` calls a chunk), which gives the engine's bytes a
transaction.
"""

from __future__ import annotations

import dataclasses

HOT_BUDGET = 0  # Definition 5: a hot phase may contain this many collectives


@dataclasses.dataclass
class LedgerEntry:
    phase: str
    hot: bool                  # True => the zero-collective budget applies
    collectives: dict          # kind -> calls, per call of the phase
    bytes_per_call: int        # bytes on the wire per call of the phase
    calls_per_chunk: float     # cadence weight in the closed loop

    @property
    def total_ops(self) -> int:
        return sum(self.collectives.values())

    @property
    def bytes_per_chunk(self) -> float:
        return self.bytes_per_call * self.calls_per_chunk


class CoordinationLedger:
    """Per-phase collective counts and bytes on the wire for one engine
    configuration."""

    def __init__(self, context: str = "", txns_per_chunk: int | None = None):
        self.context = context
        self.txns_per_chunk = txns_per_chunk
        self.entries: list[LedgerEntry] = []

    def add(self, phase: str, stats, *, hot: bool = False,
            calls_per_chunk: float = 1.0) -> LedgerEntry:
        """Add a phase from the ``collectives.CollectiveStats`` that
        ``with collectives.counted()`` read around one run of it."""
        entry = LedgerEntry(phase=phase, hot=hot,
                            collectives=dict(stats.counts),
                            bytes_per_call=int(sum(stats.bytes.values())),
                            calls_per_chunk=calls_per_chunk)
        self.entries.append(entry)
        return entry

    # -- the budget ----------------------------------------------------------

    def hot_collectives(self) -> int:
        return sum(e.total_ops for e in self.entries if e.hot)

    def assert_budget(self) -> None:
        """Every hot phase must sit at the zero-collective budget."""
        for e in self.entries:
            if e.hot and e.total_ops > HOT_BUDGET:
                raise AssertionError(
                    f"coordination budget blown in hot phase {e.phase!r}"
                    f"{' of ' + self.context if self.context else ''}: "
                    f"{e.collectives} ({e.bytes_per_call / 1e6:.2f} MB/call)")

    # -- accounting ----------------------------------------------------------

    def bytes_per_chunk(self) -> float:
        return sum(e.bytes_per_chunk for e in self.entries)

    def bytes_per_txn(self) -> float | None:
        if not self.txns_per_chunk:
            return None
        return self.bytes_per_chunk() / self.txns_per_chunk

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "context": self.context,
            "txns_per_chunk": self.txns_per_chunk,
            "hot_collectives": self.hot_collectives(),
            "bytes_per_chunk": self.bytes_per_chunk(),
            "bytes_per_txn": self.bytes_per_txn(),
            "phases": [dataclasses.asdict(e) for e in self.entries],
        }

    def table(self) -> str:
        lines = [f"coordination ledger"
                 f"{' — ' + self.context if self.context else ''}:",
                 f"  {'phase':<24}{'hot':>4}{'collectives':>26}"
                 f"{'bytes/call':>12}{'calls/chunk':>12}"]
        for e in self.entries:
            ops = ", ".join(f"{op}×{n}" for op, n in
                            sorted(e.collectives.items())) or "none"
            lines.append(f"  {e.phase:<24}{'✓' if e.hot else '':>4}"
                         f"{ops:>26}{e.bytes_per_call:>12,}"
                         f"{e.calls_per_chunk:>12.3f}")
        bpt = self.bytes_per_txn()
        lines.append(f"  hot collectives: {self.hot_collectives()} "
                     f"(budget {HOT_BUDGET}); "
                     f"{self.bytes_per_chunk():,.0f} bytes/chunk"
                     + (f", {bpt:,.1f} bytes/txn" if bpt is not None else ""))
        return "\n".join(lines)


def build_ledger(engine, *, chunk_len: int = 8, batch_per_shard: int = 8,
                 read_per_shard: int = 2, refresh_every: int = 1,
                 payments: bool = True, reads: bool = True,
                 metrics: bool = False) -> CoordinationLedger:
    """Count every phase of the engine's plan-selected fused closed loop,
    each run once on the executor's proof inputs (``init_state`` and a
    seeded chunk of the mix): the (metrics-on or -off) chunk and the RAMP
    reads as hot phases, the metrics recorders too when ``metrics``, and
    the drain as the coordinated tail (in the escrow regime the strict
    drain and the drain with the share refresh at their cadences)."""
    from repro_torch.core.planner import CoordClass
    from repro_torch.txn.executor import get_fused_executor

    ex = get_fused_executor(engine, ring_rows=chunk_len)
    escrow = engine.stock_regime is CoordClass.ESCROW
    regime = "escrow" if escrow else "merge"
    B = batch_per_shard * engine.n_shards
    R = read_per_shard * engine.n_shards
    # the committed mix a chunk (Delivery's data-dependent count left out:
    # it only tightens bytes/txn)
    txns = chunk_len * (B * (1 + int(payments)) + R * 2 * int(reads))
    led = CoordinationLedger(
        context=f"{regime} regime, {engine.n_shards} shards, "
                f"chunk_len={chunk_len}"
                + (", metrics-on" if metrics else ""),
        txns_per_chunk=txns)

    led.add("megastep (hot scan)", ex.count_megastep_collectives(
        chunk_len, batch_per_shard, read_per_shard, payments=payments,
        reads=reads, metrics=metrics), hot=True)
    if metrics:
        # the obs plane's own work enters its own ledger, hot-budgeted
        record, fold = ex.count_metrics_collectives(chunk_len,
                                                    batch_per_shard)
        led.add("metrics record", record, hot=True)
        led.add("metrics counter fold", fold, hot=True, calls_per_chunk=0.0)
    if reads:
        # the reads run inside the chunk; counted alone, they enter as hot
        # proof entries at zero cadence
        os_stats, sl_stats = engine.count_read_collectives(read_per_shard)
        led.add("order-status read", os_stats, hot=True, calls_per_chunk=0.0)
        led.add("stock-level read", sl_stats, hot=True, calls_per_chunk=0.0)
    if escrow:
        led.add("strict drain",
                ex.count_drain_strict_collectives(batch_per_shard),
                calls_per_chunk=1.0 - 1.0 / refresh_every)
        led.add("drain + share refresh",
                ex.count_drain_refresh_collectives(batch_per_shard),
                calls_per_chunk=1.0 / refresh_every)
    else:
        led.add("anti-entropy drain",
                ex.count_drain_collectives(batch_per_shard))
    led.assert_budget()
    return led
