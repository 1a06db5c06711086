"""The fused executor: a chunk of batches of the TPC-C mix as one CUDA graph.

The port of ``repro.txn.executor``. The reference runs ``merge_every``
iterations of the five-transaction mix (New-Order, Payment, RAMP
Order-Status and Stock-Level, Delivery) inside one donated ``lax.scan``
under ``shard_map``, so the host enters once a chunk. Here:

* **the chunk** — the same steps run on all R shards in the dispatch
  path's order; each step's remote-stock outbox is copied into row ``i`` of
  a fixed :class:`OutboxRing` and every MixStats counter accumulates into
  fixed ``[R]`` int32 tensors (:class:`MixCounters`). On the card the chunk
  is captured once a distinct chunk length as a ``torch.cuda.CUDAGraph``
  and each chunk is one replay: its stacked batches are copied into the
  graph's input buffers, outside the graph, and ``replay()`` runs every
  kernel and torch op of every shard. On the CPU, which only a caller that
  asks for it gets, the chunk runs eagerly. There is no other path: a
  capture or a replay that fails raises.
* **the drain** — between chunks, at the host's cadence, one batched
  anti-entropy call applies the whole ring, gathered shard-major as the
  reference's ``all_gather`` of its ``[rows, R]`` ring lays it out; in the
  escrow regime the strict drain, fused with the share refresh every
  ``refresh_every`` chunks or adaptively (one host read of the abort
  counters a chunk), and with the cold-retry ring where ``retry_cap`` > 0.
* **fixed buffers** — state, escrow, ring, counters and the retry ring are
  updated in place for the whole run, the analogue of donation: the graph
  holds their addresses, and the refresh writes the new shares into the
  escrow's own tensors (``Engine.refresh_escrow``).
* **observability** — ``run(obs=)`` and ``run_escrow(obs=)`` take a
  ``repro_torch.obs.ObsSession``: tracer spans around each replay and
  each drain (on the card also around the call's set-up, its captures
  and its close, outside the wall clock), and the metrics lattice fed
  after the wall clock stops from the chunks' own batches. The merge
  regime captures the metrics-off graph; the escrow regime's also writes
  each step's commit mask into an :class:`OkBuffer`, the reference's scan
  ``ys``.

A graph captures no host read. Payment's ordered adds take their round
count as a static argument (``MixChunk.pay_rounds``, read from the stream
before the timed loop); the ``admission="auto"`` probe is resolved in the
warm-up; the warm-up runs one step under
``torch.cuda.set_sync_debug_mode("error")``, so a read that slipped in
raises there. The wrappers of the kernels count Python calls, and a replay
makes none: the launches a graph captured are counted once a replay
instead, so the counts are the launches the card ran.

Why the chunked drain gives the dispatch path's state: the stock adds are
integer-valued and exact in any order, and the restock rule keeps
``s_quantity`` in one residue window, so any grouping of the same deltas
converges to the same state (the reference's argument). The cold-retry
ring enqueues fresh rejects in gather order, shard-major here as in the
reference's executor and row-major in both packages' dispatch path: at
R > 1 the rings hold the same entries an owner, in another lane order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from collections import Counter
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.planner import CoordClass
from repro_torch.device import synchronize
from repro_torch.kernels.escrow_admit import escrow_admit_cuda
from repro_torch.kernels.ramp_read import ramp_read_cuda
from repro_torch.kernels.txn_megastep import txn_megastep_cuda
from repro_torch.obs import metrics as obsm

from . import collectives, tpcc
from .tpcc import (NewOrderBatch, OrderStatusBatch, PaymentBatch, StockDelta,
                   StockLevelBatch, TPCCState)

# the kernels a chunk can launch; their wrappers count launches
KERNELS = (escrow_admit_cuda, txn_megastep_cuda, ramp_read_cuda)


class OutboxRing(NamedTuple):
    """Fixed ``[rows, R]`` ring of per-step remote-stock outboxes: row ``i``
    holds step ``i``'s outbox (``R = B * L`` entries, shard-major), and the
    drain between chunks applies every row and clears ``valid``."""

    dst_w: torch.Tensor  # [rows, R] int32 destination warehouse
    i_id: torch.Tensor   # [rows, R] int32
    qty: torch.Tensor    # [rows, R] int32
    valid: torch.Tensor  # [rows, R] bool

    @property
    def rows(self) -> int:
        return self.valid.shape[0]


class MixCounters(NamedTuple):
    """MixStats accumulators on the device, one int32 lane a shard
    (``[n_shards]``); the host reads them once, after the run."""

    neworders: torch.Tensor
    payments: torch.Tensor
    order_statuses: torch.Tensor
    stock_levels: torch.Tensor
    deliveries: torch.Tensor
    reads_found: torch.Tensor
    fractures_observed: torch.Tensor
    lines_repaired: torch.Tensor
    aborts: torch.Tensor   # escrow regime: insufficient-share aborts


class MixChunk(NamedTuple):
    """``chunk_len`` batches stacked along a leading axis, on the device.
    ``payment`` / ``order_status`` / ``stock_level`` may be None (a reduced
    mix). ``pay_rounds`` is the chaining rounds Payment's ordered adds take
    (``tpcc.payment_rounds`` of the chunk's Payment batches), static so a
    graph can capture them; it is not in the reference's MixChunk, whose
    scatter-add needs none."""

    neworder: NewOrderBatch
    payment: PaymentBatch | None
    order_status: OrderStatusBatch | None
    stock_level: StockLevelBatch | None
    pay_rounds: int = 0

    @property
    def chunk_len(self) -> int:
        return self.neworder.w.shape[0]

    def tensors(self) -> list[torch.Tensor]:
        return [x for b in self[:4] if b is not None for x in b]


def _stack(batches):
    return type(batches[0])(*(torch.stack(xs) for xs in zip(*batches)))


def stack_chunks(no_batches: Sequence[NewOrderBatch],
                 pay_batches: Sequence[PaymentBatch] | None,
                 os_batches: Sequence[OrderStatusBatch] | None,
                 sl_batches: Sequence[StockLevelBatch] | None,
                 merge_every: int) -> list[MixChunk]:
    """Group per-step batches into stacked MixChunks of <= merge_every
    steps, on the batches' device; each chunk's ``pay_rounds`` is read
    once on the host here, before any timed loop."""
    chunks = []
    for lo in range(0, len(no_batches), merge_every):
        sl = slice(lo, min(lo + merge_every, len(no_batches)))
        pay = _stack(pay_batches[sl]) if pay_batches else None
        chunks.append(MixChunk(
            neworder=_stack(no_batches[sl]), payment=pay,
            order_status=_stack(os_batches[sl]) if os_batches else None,
            stock_level=_stack(sl_batches[sl]) if sl_batches else None,
            pay_rounds=0 if pay is None else tpcc.payment_rounds(pay.w)))
    return chunks


class OkBuffer(NamedTuple):
    """Where a metrics-on escrow run keeps each step's commit mask, the
    reference's scan ``ys``: ``buf[c, i]`` is step ``i`` of the run's
    chunk ``c``. Step ``i`` writes row ``cursor`` of ``buf[:, i]`` and the
    chunk ends by advancing ``cursor``, a device tensor that every graph of
    the run shares, so a replay writes its chunk's slot and the next one
    the next."""

    buf: torch.Tensor     # [n_chunks, ring_rows, R * B] bool
    cursor: torch.Tensor  # [1] int64, the chunk being run

    def copy(self) -> "OkBuffer":
        return OkBuffer(self.buf.clone(), self.cursor.clone())


def launch_counts() -> Counter:
    """Each chunk kernel's launch count (its wrapper's ``launches``)."""
    return Counter({k.__name__: k.launches for k in KERNELS})


class _Graph:
    """One captured chunk of ``T`` steps: its input buffers, the launches
    it captured, the bytes of its memory pool and its replays. It keeps
    the live buffers it was captured on (``live``: state, ring, counters,
    escrow), whose addresses it holds."""

    def __init__(self, ex, T: int, chunk: MixChunk, rounds: int, live,
                 oks: OkBuffer | None, span):
        dev = ex.engine.device
        self.T = T
        self.live = live
        self.inputs = MixChunk(*(None if b is None else type(b)(
            *(x.clone() for x in b)) for b in chunk[:4]), pay_rounds=rounds)
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        before = launch_counts()
        with span("capture-wait"):
            synchronize(dev)
        # a graph freed in the middle of a capture (an earlier run's, held
        # in a reference cycle until the collector finds it) invalidates
        # the capture: collect first, and hold the collector off meanwhile
        with span("collect"):
            gc.collect()
        with span("cache-release"):
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the span opens before the capture begins and closes after it
            # ends (and the graph is instantiated)
            with span("graph-record"), torch.cuda.graph(self.graph):
                ex._chunk(*live, self.inputs, oks)
        finally:
            if collecting:
                gc.enable()
            # a capture launches nothing: its counts move to the replays
            self.launches = launch_counts() - before
            for k in KERNELS:
                k.launches -= self.launches[k.__name__]
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def load(self, chunk: MixChunk) -> None:
        """Copy ``chunk``'s batches into the input buffers (on the current
        stream, outside the graph)."""
        for x, y in zip(self.inputs.tensors(), chunk.tensors()):
            x.copy_(y)

    def replay(self) -> None:
        """One replay; each kernel's count grows by its captured launches."""
        self.graph.replay()
        self.replays += 1
        for k in KERNELS:
            k.launches += self.launches[k.__name__]


@dataclasses.dataclass
class FusedExecutor:
    """Chunked executor over an :class:`~repro_torch.txn.engine.Engine`.

    ``ring_rows`` bounds the steps a chunk may take between drains;
    ``deliveries`` adds the per-step Delivery transaction. ``retry_cap`` >
    0 (sparse escrow only) adds the bounded cold-retry ring to the drains:
    owner-rejected remote-cold entries re-present for up to ``retry_max``
    drain windows (a knob of :meth:`run_escrow`) before they count as final
    rejects.

    After a run on the card, ``last_run`` holds the run's graphs by chunk
    length (their launches, pool bytes and replays) and, from CUDA events,
    each chunk replay's and each drain's milliseconds. After a run whose
    session wants metrics (card or CPU) it also holds ``drain_lanes`` and
    ``drain_live_lanes``: how many lanes the drains' stock scatters took,
    and how many of them carried work.
    """

    engine: object
    ring_rows: int = 8
    deliveries: bool = True
    retry_cap: int = 0

    def __post_init__(self):
        eng = self.engine
        self._escrow = eng.stock_regime is CoordClass.ESCROW
        self._sparse = self._escrow and eng.escrow_layout == "sparse"
        self._cuda = eng.device.type == "cuda"
        self.last_run: dict = {}
        if self.retry_cap > 0 and not self._sparse:
            raise ValueError("retry_cap > 0 requires the sparse "
                             "(two-tier) escrow layout — the retry ring "
                             "holds cold-tier entries")

    # -- device buffers ------------------------------------------------------

    def init_ring(self, batch_per_shard: int) -> OutboxRing:
        eng = self.engine
        R = batch_per_shard * eng.n_shards * eng.scale.max_lines
        z = lambda dt: torch.zeros((self.ring_rows, R), dtype=dt,  # noqa: E731
                                   device=eng.device)
        return OutboxRing(z(torch.int32), z(torch.int32), z(torch.int32),
                          z(torch.bool))

    def init_counters(self) -> MixCounters:
        return MixCounters(*(torch.zeros((self.engine.n_shards,),
                                         dtype=torch.int32,
                                         device=self.engine.device)
                             for _ in MixCounters._fields))

    # -- the chunk body -------------------------------------------------------

    def _step(self, state, ring, cnt, esc, chunk: MixChunk, i: int,
              oks: OkBuffer | None = None) -> None:
        """Step ``i`` of ``chunk`` on every shard, in the dispatch path's
        order; everything it changes is a fixed buffer, updated in place.
        With ``oks`` (a metrics-on escrow run) the step also writes its
        commit mask there, the only op metrics add to a chunk."""
        eng = self.engine
        n = eng.n_shards
        per = lambda x: x.reshape(n, -1).sum(1).to(torch.int32)  # noqa: E731
        no_b = type(chunk.neworder)(*(x[i] for x in chunk.neworder))
        B = no_b.w.shape[0] // n
        if self._escrow:
            _, _, delta, _, ok = eng.neworder_escrow_step(state, esc, no_b)
            n_ok = per(ok)
            cnt.neworders.add_(n_ok)
            cnt.aborts.add_(B - n_ok)
            if oks is not None:
                oks.buf[:, i].index_copy_(0, oks.cursor, ok[None])
        else:
            _, delta, _ = eng.neworder_step(state, no_b)
            cnt.neworders.add_(B)
        for r, v in zip(ring, delta):
            r[i].copy_(v)
        if chunk.payment is not None:
            pay = type(chunk.payment)(*(x[i] for x in chunk.payment))
            eng.payment_step(state, pay, rounds=chunk.pay_rounds)
            cnt.payments.add_(pay.w.shape[0] // n)
        if chunk.order_status is not None:
            osb = type(chunk.order_status)(*(x[i] for x in
                                             chunk.order_status))
            res = eng.order_status_step(state, osb)
            cnt.order_statuses.add_(osb.w.shape[0] // n)
            cnt.reads_found.add_(per(res.found))
            cnt.fractures_observed.add_(
                per(res.found & (res.lines_read < res.n_lines)))
            cnt.lines_repaired.add_(per(res.repaired))
        if chunk.stock_level is not None:
            slb = type(chunk.stock_level)(*(x[i] for x in chunk.stock_level))
            res = eng.stock_level_step(state, slb)
            cnt.stock_levels.add_(slb.w.shape[0] // n)
            cnt.fractures_observed.add_(per(res.fractured - res.repaired))
            cnt.lines_repaired.add_(per(res.repaired))
        if self.deliveries:
            _, delivered = eng.delivery_step(state)
            cnt.deliveries.add_(delivered)

    def _chunk(self, state, ring, counters, esc, chunk: MixChunk,
               oks: OkBuffer | None = None) -> None:
        for i in range(chunk.chunk_len):
            self._step(state, ring, counters, esc, chunk, i, oks)
        if oks is not None:
            oks.cursor.add_(1)

    def _check_len(self, chunk: MixChunk) -> None:
        if chunk.chunk_len > self.ring_rows:
            raise ValueError(f"chunk of {chunk.chunk_len} steps exceeds the "
                             f"{self.ring_rows}-row outbox ring")

    def _warm(self, state, ring, counters, esc, chunk: MixChunk,
              oks: OkBuffer | None = None) -> None:
        """One step of ``chunk`` on copies, before any capture: it builds
        the kernels, resolves the admission probe first, and on the card
        runs under the host-sync check, so a host read in the step raises
        here. Its kernel launches are real and counted, as the dispatch
        path's warm-up batch's are."""
        eng = self.engine
        B = chunk.neworder.w.shape[1] // eng.n_shards
        L = eng.scale.max_lines
        if self._escrow:
            tpcc.resolve_admission(eng.admission, B, L, eng.device)
        copy = tpcc.copy_tree
        args = (copy(state), copy(ring), copy(counters),
                None if esc is None else copy(esc))
        oks = None if oks is None else oks.copy()
        one = MixChunk(*(None if b is None else type(b)(*(x[:1] for x in b))
                         for b in chunk[:4]), pay_rounds=chunk.pay_rounds)
        mode = torch.cuda.get_sync_debug_mode() if self._cuda else None
        if self._cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            self._chunk(*args, one, oks)
        finally:
            if self._cuda:
                torch.cuda.set_sync_debug_mode(mode)
        synchronize(eng.device)

    def _check_resolved(self, chunk: MixChunk) -> None:
        """The admission strategy is resolved (no timing probe, which reads
        the clock around synchronisations, can run inside a capture)."""
        eng = self.engine
        if not self._escrow:
            return
        B = chunk.neworder.w.shape[1] // eng.n_shards
        if not tpcc.admission_resolved(eng.admission, B, eng.scale.max_lines,
                                       eng.device):
            raise RuntimeError("capture before the admission probe was "
                               "resolved: the warm-up resolves it")

    def _prepare(self, state, ring, counters, esc, chunks,
                 oks: OkBuffer | None = None, span=contextlib.nullcontext):
        """The run's graphs, one a distinct chunk length, each captured in
        a "capture" span (the card); {} on the CPU."""
        if not self._cuda:
            return {}
        graphs = {}
        live = (state, ring, counters, esc)
        for T in sorted({c.chunk_len for c in chunks}):
            same = [c for c in chunks if c.chunk_len == T]
            self._check_resolved(same[0])
            # the stream's deepest Payment of this length: extra rounds
            # are no-ops, so one graph serves every chunk
            rounds = max(c.pay_rounds for c in same)
            with span("capture"):
                graphs[T] = _Graph(self, T, same[0], rounds, live, oks, span)
        self.last_run = dict(graphs=graphs, chunk_ms=[], drain_ms=[])
        return graphs

    def _execute(self, graphs, state, ring, counters, esc, chunk,
                 oks: OkBuffer | None = None):
        if not self._cuda:
            self._chunk(state, ring, counters, esc, chunk, oks)
            return
        g = graphs[chunk.chunk_len]
        g.load(chunk)
        self._timed("chunk_ms", g.replay)

    def _timed(self, what: str, fn):
        """``fn()``, its CUDA events kept under ``last_run[what]`` (card)."""
        if not self._cuda:
            return fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        self.last_run[what].append(ev)
        return out

    def _finish_events(self) -> None:
        for k in ("chunk_ms", "drain_ms"):
            if k in self.last_run:
                self.last_run[k] = [a.elapsed_time(b)
                                    for a, b in self.last_run[k]]

    # -- execution ------------------------------------------------------------

    def _one(self, state, ring, counters, esc, chunk: MixChunk) -> None:
        """One chunk as a run takes it: on the card a warm-up step, a
        capture on these buffers and one replay; on the CPU eagerly."""
        self._check_len(chunk)
        live = (state, ring, counters, esc)
        self.last_run = {}
        self._warm(*live, chunk)
        self._execute(self._prepare(*live, [chunk]), *live, chunk)
        self._finish_events()

    def megastep(self, state: TPCCState, ring: OutboxRing,
                 counters: MixCounters, chunk: MixChunk):
        """Run one chunk (<= ring_rows steps) in place; the merge regime.
        Returns (state, ring, counters), the same tensors."""
        if self._escrow:
            raise RuntimeError("escrow-regime executor: use megastep_escrow")
        self._one(state, ring, counters, None, chunk)
        return state, ring, counters

    def megastep_escrow(self, state: TPCCState, ring: OutboxRing,
                        counters: MixCounters, esc, chunk: MixChunk):
        """Escrow-regime chunk: the escrow's spent joins the fixed buffers.
        Returns (state, ring, counters, esc)."""
        if not self._escrow:
            raise RuntimeError("executor is not in the escrow regime: use "
                               "megastep")
        self._one(state, ring, counters, esc, chunk)
        return state, ring, counters, esc

    def _flat(self, ring: OutboxRing) -> StockDelta:
        """The ring as one outbox in the reference's gathered order: shard
        by shard, each shard's rows in order (its ``[rows, R / n]`` block
        flattened)."""
        rows, width = ring.valid.shape
        n = self.engine.n_shards
        return StockDelta(*(x.view(rows, n, width // n).transpose(0, 1)
                            .reshape(-1) for x in ring))

    def drain(self, state: TPCCState, ring: OutboxRing,
              span=contextlib.nullcontext):
        """Anti-entropy over the whole ring (merge regime: restocking
        apply); clears its valid bits. Returns (state, ring). ``span``
        wraps the gather and each owner's apply (``Engine.anti_entropy``);
        without one the engine is called in its two-argument form, the
        one that stand-ins for its drain (the benchmark's faults) keep."""
        flat = self._flat(ring)
        state = (self.engine.anti_entropy(state, flat)
                 if span is contextlib.nullcontext
                 else self.engine.anti_entropy(state, flat, span))
        ring.valid.zero_()
        return state, ring

    def drain_strict(self, state: TPCCState, ring: OutboxRing):
        """Strict ring drain (hot unconditional, cold all-or-nothing at the
        owner). Returns (state, ring, per-shard cold rejects)."""
        state, rej = self.engine.drain_strict(state, self._flat(ring))
        ring.valid.zero_()
        return state, ring, rej

    def drain_refresh(self, state: TPCCState, ring: OutboxRing, esc,
                      alive=None):
        """Strict drain, then the share refresh into ``esc``'s tensors.
        Returns (state, ring, esc, per-shard cold rejects). ``alive``
        ([n_shards] mask, default all live) reclaims dead replicas'
        headroom for the survivors."""
        state, ring, rej = self.drain_strict(state, ring)
        return state, ring, self.engine.refresh_escrow(state, esc, alive), rej

    def init_retry(self):
        """Every owner's empty retry ring (``[n_shards, retry_cap]``)."""
        if self.retry_cap <= 0:
            raise RuntimeError("executor built with retry_cap=0")
        return self.engine.init_retry(self.retry_cap)

    def drain_strict_retry(self, state: TPCCState, ring: OutboxRing,
                           retry, retry_max=0, reserve=0):
        """Retry-aware strict ring drain; ``retry`` is updated in place.
        Returns (state, ring, retry, per-shard FINAL-reject counts)."""
        state, new, rej = self.engine.drain_strict_retry(
            state, self._flat(ring), retry, retry_max, reserve)
        for x, y in zip(retry, new):
            x.copy_(y)
        ring.valid.zero_()
        return state, ring, retry, rej

    def drain_refresh_retry(self, state: TPCCState, ring: OutboxRing,
                            retry, esc, alive=None, retry_max=0, reserve=0):
        """Retry-aware drain, then the share refresh. Returns (state, ring,
        retry, esc, per-shard final rejects)."""
        state, ring, retry, rej = self.drain_strict_retry(
            state, ring, retry, retry_max, reserve)
        return (state, ring, retry,
                self.engine.refresh_escrow(state, esc, alive), rej)

    def run(self, state: TPCCState, chunks: Sequence[MixChunk], *,
            warmup: bool = True, obs=None
            ) -> tuple[TPCCState, MixCounters, float]:
        """Drive every chunk, one drain after each, one host sync at the
        end. Returns (state, counters, wall_seconds); wall time excludes
        the warm-up and the captures.

        ``obs`` (a ``repro_torch.obs.ObsSession``) wraps each replay and
        each drain in a tracer span and, when the session wants metrics,
        feeds its lattice (``obs.device_metrics``): the captured chunk is
        the metrics-off graph, and after the wall clock stops each chunk's
        record and one counter fold run from the chunks' own batches; the
        joins commute, so that equals recording inline, and the timed loop
        launches nothing more. On the card the call's set-up and close,
        and each timed drain's gather and owner applies, are spans too
        (:meth:`_spans`)."""
        span, call_span = self._spans(obs)
        with call_span("call-setup"):
            if self._escrow:
                raise RuntimeError("escrow-regime executor: use run_escrow")
            for c in chunks:
                self._check_len(c)
            eng = self.engine
            with call_span("release"):
                self.last_run = {}
            with call_span("buffers"):
                state = eng.shard_state(state)
                ring = self.init_ring(
                    chunks[0].neworder.w.shape[1] // eng.n_shards)
                counters = self.init_counters()
                metrics = self._metrics(obs)
                live = self._live_lanes(metrics)
            if warmup:
                with call_span("warm"):
                    self._warm_drain(state, ring, None)
                    self._warm(state, ring, counters, None, chunks[0])
            graphs = self._prepare(state, ring, counters, None, chunks,
                                   span=call_span)
            with call_span("loop-wait"):
                synchronize(eng.device)
        t0 = time.perf_counter()
        for chunk in chunks:
            with span("megastep"):
                self._execute(graphs, state, ring, counters, None, chunk)
                if obs is not None:
                    obs.maybe_sync(counters)
            if live is not None:
                live.add_(eng.owned_lanes(ring))
            with span("outbox-drain"):
                self._timed("drain_ms",
                            lambda: self.drain(state, ring, call_span))
                if obs is not None:
                    obs.maybe_sync(ring)
        synchronize(eng.device)
        wall = time.perf_counter() - t0
        with call_span("call-close"):
            self._finish_events()
            if metrics is not None:
                for chunk in chunks:
                    metrics = obsm.record_chunk(metrics, chunk.neworder,
                                                None)
                obs.device_metrics = self._fold(metrics, counters)
                self._count_lanes(live, len(chunks), ring)
        return state, counters, wall

    def _spans(self, obs):
        """The session's span, and the span of the call's life cycle: its
        set-up (``call-setup``: ``release``, ``buffers``, ``warm``, a
        ``capture`` a graph with ``capture-wait``, ``collect``,
        ``cache-release`` and ``graph-record``, then ``loop-wait``) and
        its close after the wall clock stops (``call-close``); in
        :meth:`run`, inside each timed ``outbox-drain``, the gather
        (``outbox-gather``) and an ``owner-apply`` a shard. The second
        is the first on the card and a null one on the CPU, which captures
        and waits for nothing and keeps the JAX package's phases. Both are
        null without a session (``nullcontext(phase)``)."""
        if obs is None:
            return contextlib.nullcontext, contextlib.nullcontext
        return obs.span, obs.span if self._cuda else contextlib.nullcontext

    def _metrics(self, obs):
        """The session's lattice, None when it wants no metrics."""
        if obs is None or not obs.wants_metrics:
            return None
        return obs.init_metrics(self.engine)

    def _live_lanes(self, metrics):
        """The drains' live-lane sum on the device, None when the session
        wants no metrics (the timed loop then launches nothing for it)."""
        if metrics is None:
            return None
        return torch.zeros((), dtype=torch.int64, device=self.engine.device)

    def _count_lanes(self, live, drains: int, ring: OutboxRing) -> None:
        """``last_run["drain_lanes"]``, the lanes the drains' stock
        scatters took (each owner takes the whole ring), and
        ``["drain_live_lanes"]``, those of them that carry work: read
        after the wall clock."""
        self.last_run["drain_lanes"] = (drains * self.engine.n_shards
                                        * ring.valid.numel())
        self.last_run["drain_live_lanes"] = int(live)

    @staticmethod
    def _fold(metrics, counters: MixCounters):
        return obsm.fold_counters(metrics, counters.payments,
                                  counters.order_statuses,
                                  counters.stock_levels, counters.deliveries,
                                  counters.aborts)

    def _warm_drain(self, state, ring, esc, retry_max=0, reserve=0) -> None:
        """The drains (and the refresh) once on copies, as the dispatch
        path warms them."""
        copy = tpcc.copy_tree
        s, r = copy(state), copy(ring)
        if not self._escrow:
            self.drain(s, r)
        elif self.retry_cap > 0:
            self.drain_refresh_retry(s, r, self.init_retry(), copy(esc),
                                     None, retry_max, reserve)
        else:
            self.drain_refresh(s, r, copy(esc))
        synchronize(self.engine.device)

    def _drain_window(self, state, ring, esc, retry, refresh: bool, alive,
                      retry_max, reserve) -> torch.Tensor:
        """The escrow regime's drain after a chunk, through the retry ring
        where there is one, with the share refresh when ``refresh``.
        Returns the per-shard (final) cold rejects."""
        if retry is not None and refresh:
            return self.drain_refresh_retry(state, ring, retry, esc, alive,
                                            retry_max, reserve)[-1]
        if retry is not None:
            return self.drain_strict_retry(state, ring, retry, retry_max,
                                           reserve)[-1]
        if refresh:
            return self.drain_refresh(state, ring, esc, alive)[-1]
        return self.drain_strict(state, ring)[-1]

    def run_escrow(self, state: TPCCState, esc, chunks: Sequence[MixChunk],
                   *, refresh_every: int = 1,
                   refresh_abort_rate: float | None = None,
                   warmup: bool = True, obs=None, retry=None,
                   retry_max: int = 0, alive=None, reserve: int = 0,
                   liveness=None, final_flush: bool = True):
        """Escrow-regime drive: a chunk, then one strict drain; the shares
        refresh every ``refresh_every``-th drain, or adaptively when any
        replica's abort rate since the last refresh crosses
        ``refresh_abort_rate`` (one host read of the abort counters a
        chunk). With ``retry_cap`` > 0 the drains carry the cold-retry ring
        (``retry``, default a fresh one, copied into the run's own buffers)
        and ``cold_rejects`` counts FINAL rejects; ``final_flush`` adds the
        run-end pending entries to it. ``alive`` ([n_shards] mask) feeds
        every refresh; ``liveness`` (a ``runtime.liveness.LeaseMonitor``)
        derives it instead, ticked once a chunk. ``obs`` as :meth:`run`
        takes it; with metrics the captured chunk also writes each step's
        commit mask into an :class:`OkBuffer` (the reference's scan ``ys``),
        and each drain's cold rejects join the lattice after the loop.
        Returns (state, esc, counters, wall_seconds, refreshes,
        cold_rejects, retry)."""
        span, call_span = self._spans(obs)
        with call_span("call-setup"):
            from .drivers import _adaptive_refresh_due

            if not self._escrow:
                raise RuntimeError("executor is not in the escrow regime "
                                   "(engine plan says merge) — use run()")
            for c in chunks:
                self._check_len(c)
            eng = self.engine
            use_retry = self.retry_cap > 0
            with call_span("release"):
                self.last_run = {}
            with call_span("buffers"):
                if use_retry:
                    retry = self.init_retry() if retry is None else \
                        tpcc.RetryState(*(x.to(eng.device).clone()
                                          for x in retry))
                bps = chunks[0].neworder.w.shape[1] // eng.n_shards
                state = eng.shard_state(state)
                ring = self.init_ring(bps)
                counters = self.init_counters()
                metrics = self._metrics(obs)
                oks = None if metrics is None else OkBuffer(
                    torch.zeros((len(chunks), self.ring_rows,
                                 chunks[0].neworder.w.shape[1]),
                                dtype=torch.bool, device=eng.device),
                    torch.zeros((1,), dtype=torch.int64, device=eng.device))
                live = self._live_lanes(metrics)
            if warmup:
                with call_span("warm"):
                    self._warm_drain(state, ring, esc, retry_max, reserve)
                    self._warm(state, ring, counters, esc, chunks[0], oks)
            graphs = self._prepare(state, ring, counters, esc, chunks, oks,
                                   call_span)

            adaptive = refresh_abort_rate is not None
            aborts_at_refresh = np.zeros(eng.n_shards, np.int64)
            txns_at_refresh = txns_so_far = 0
            refreshes = 0
            rej_acc = torch.zeros((eng.n_shards,), dtype=torch.int32,
                                  device=eng.device)
            rejs = []
            with call_span("loop-wait"):
                synchronize(eng.device)
        t0 = time.perf_counter()
        for ci, chunk in enumerate(chunks):
            with span("megastep"):
                self._execute(graphs, state, ring, counters, esc, chunk, oks)
                if obs is not None:
                    obs.maybe_sync(counters)
            if adaptive:
                # the one host read adaptive control costs, per chunk
                ab = counters.aborts.cpu().numpy().astype(np.int64)
                txns_so_far += chunk.chunk_len * bps
                due = _adaptive_refresh_due(ab - aborts_at_refresh,
                                            txns_so_far - txns_at_refresh,
                                            refresh_abort_rate)
                if due:
                    aborts_at_refresh = ab
                    txns_at_refresh = txns_so_far
            else:
                due = (ci + 1) % refresh_every == 0
            if liveness is not None:
                # one monitor tick a drain window, feeding its refresh
                alive = liveness.tick().astype(np.int32)
            if live is not None:
                live.add_(eng.owned_lanes(ring))
            with span("share-refresh" if due else "outbox-drain"):
                rej = self._timed("drain_ms", lambda: self._drain_window(
                    state, ring, esc, retry if use_retry else None, due,
                    alive, retry_max, reserve))
                if obs is not None:
                    obs.maybe_sync(esc if due else ring)
            rej_acc.add_(rej)
            if metrics is not None:
                rejs.append(rej)   # each drain's own tensor
            refreshes += int(due)
        synchronize(eng.device)
        wall = time.perf_counter() - t0
        with call_span("call-close"):
            self._finish_events()
            if metrics is not None:
                if int(oks.cursor) != len(chunks):
                    raise RuntimeError(
                        f"the commit masks of {int(oks.cursor)} chunks "
                        f"were written, of {len(chunks)}")
                for ci, chunk in enumerate(chunks):
                    metrics = obsm.record_chunk(
                        metrics, chunk.neworder,
                        oks.buf[ci, :chunk.chunk_len])
                for rej in rejs:
                    metrics = obsm.add_cold_rejects(metrics, rej)
                obs.device_metrics = self._fold(metrics, counters)
                self._count_lanes(live, len(chunks), ring)
            cold = int(rej_acc.sum())
            if use_retry and final_flush:
                # entries still pending never got their last window: final
                # rejects (one host read)
                cold += int(retry.valid.sum())
        return state, esc, counters, wall, refreshes, cold, retry

    # -- structural proofs ----------------------------------------------------

    def _proof_inputs(self, chunk_len: int, batch_per_shard: int,
                      read_per_shard: int):
        """``init_state``, a fresh ring, counters and escrow, and a chunk of
        the full mix from a fixed seed."""
        from .drivers import generate_mix_batches

        eng = self.engine
        state = tpcc.init_state(eng.scale, device=eng.device)
        esc = eng.init_escrow(state) if self._escrow else None
        no_b, pay_b, os_b, sl_b = generate_mix_batches(
            eng, batch_per_shard=batch_per_shard, n_batches=chunk_len,
            remote_frac=0.5, read_frac=read_per_shard / batch_per_shard,
            seed=0)
        chunk = stack_chunks(no_b, pay_b, os_b, sl_b, chunk_len)[0]
        return (state, self.init_ring(batch_per_shard), self.init_counters(),
                esc, chunk)

    def count_megastep_collectives(self, chunk_len: int = 8,
                                   batch_per_shard: int = 8,
                                   read_per_shard: int = 2,
                                   payments: bool = True, reads: bool = True,
                                   metrics: bool = False):
        """The collectives of one chunk of ``chunk_len`` steps of the mix
        (Payment and the reads as ``payments`` and ``reads`` say), as a
        metrics-on run's chunk when ``metrics`` (in the escrow regime it
        writes the commit masks), on the proof inputs."""
        if chunk_len > self.ring_rows:
            raise ValueError(f"chunk of {chunk_len} steps exceeds the "
                             f"{self.ring_rows}-row outbox ring")
        *live, chunk = self._proof_inputs(chunk_len, batch_per_shard,
                                          read_per_shard)
        chunk = chunk._replace(
            payment=chunk.payment if payments else None,
            order_status=chunk.order_status if reads else None,
            stock_level=chunk.stock_level if reads else None)
        oks = None
        if metrics and self._escrow:
            dev = self.engine.device
            oks = OkBuffer(torch.zeros((1, self.ring_rows,
                                        chunk.neworder.w.shape[1]),
                                       dtype=torch.bool, device=dev),
                           torch.zeros((1,), dtype=torch.int64, device=dev))
        with collectives.counted() as stats:
            self._chunk(*live, chunk, oks)
        return stats

    def count_metrics_collectives(self, chunk_len: int = 8,
                                  batch_per_shard: int = 8):
        """The collectives of the obs plane's record of one chunk (with its
        commit masks in the escrow regime) and of its counter fold, on the
        proof inputs: (record stats, fold stats)."""
        _, _, counters, _, chunk = self._proof_inputs(chunk_len,
                                                      batch_per_shard, 1)
        m = obsm.init_obs_metrics(self.engine)
        ok = (torch.ones(chunk.neworder.w.shape, dtype=torch.bool,
                         device=self.engine.device) if self._escrow
              else None)
        with collectives.counted() as record:
            obsm.record_chunk(m, chunk.neworder, ok)
        with collectives.counted() as fold:
            self._fold(m, counters)
        return record, fold

    def prove_megastep_coordination_free(self, chunk_len: int = 8,
                                         batch_per_shard: int = 8,
                                         read_per_shard: int = 2,
                                         metrics: bool = False) -> str:
        """Definition 5 on the fused hot path: a chunk of ``chunk_len``
        full-mix steps (the escrow regime's strict admission included)
        calls no collective, by ``txn/collectives.py``'s counts.
        ``metrics=True`` proves the same for all a metrics-on run does a
        chunk: its chunk and the obs plane's record and counter fold.
        Returns the chunk's stats line."""
        ctx = "fused TPC-C escrow megastep" if self._escrow \
            else "fused TPC-C megastep"
        if metrics:
            ctx += " (metrics-on)"
        stats = self.count_megastep_collectives(
            chunk_len, batch_per_shard, read_per_shard, metrics=metrics)
        checks = [(ctx, stats)]
        if metrics:
            record, fold = self.count_metrics_collectives(chunk_len,
                                                          batch_per_shard)
            checks += [(ctx + " record program", record),
                       (ctx + " counter-fold program", fold)]
        for what, st in checks:
            if st.total_ops:
                raise AssertionError(f"coordination-free path contains "
                                     f"collectives in {what}: "
                                     f"{st.describe()}")
        return stats.describe()

    def _count_drain(self, drain, batch_per_shard: int):
        state, ring, _, esc, _ = self._proof_inputs(1, batch_per_shard, 1)
        with collectives.counted() as stats:
            drain(state, ring, esc)
        return stats

    def count_drain_collectives(self, batch_per_shard: int = 8):
        """The merge regime's ring drain."""
        return self._count_drain(lambda s, r, e: self.drain(s, r),
                                 batch_per_shard)

    def count_drain_strict_collectives(self, batch_per_shard: int = 8):
        """The escrow regime's ring drain without a refresh."""
        return self._count_drain(lambda s, r, e: self.drain_strict(s, r),
                                 batch_per_shard)

    def count_drain_refresh_collectives(self, batch_per_shard: int = 8):
        """The escrow regime's drain with the share refresh."""
        return self._count_drain(lambda s, r, e: self.drain_refresh(s, r, e),
                                 batch_per_shard)

    def count_drain_strict_retry_collectives(self, batch_per_shard: int = 8):
        """The retry-aware ring drain: the ring is owner-local and never
        gathered, so it costs what the strict drain costs."""
        return self._count_drain(
            lambda s, r, e: self.drain_strict_retry(s, r, self.init_retry()),
            batch_per_shard)


def get_fused_executor(engine, ring_rows: int = 8, deliveries: bool = True,
                       retry_cap: int = 0) -> FusedExecutor:
    """The engine's executor for these knobs, built once and reused."""
    cache = engine.__dict__.setdefault("_fused_executors", {})
    key = (ring_rows, deliveries, retry_cap)
    if key not in cache:
        cache[key] = FusedExecutor(engine, ring_rows=ring_rows,
                                   deliveries=deliveries,
                                   retry_cap=retry_cap)
    return cache[key]
