"""The TPC-C closed loop on one card: the port of ``repro.txn.drivers``.

:func:`run_loop` is the one core; ``fused=True`` (the default, as in the
reference) runs the fused executor (``txn/executor.py``: on the card each
chunk of ``merge_every`` batches is one CUDA graph replay), ``fused=False``
the per-batch dispatch path, and ``legacy=True`` the dispatch path with the
seed's host behaviour (a host read of every batch's stats, and in the
merge regime one anti-entropy call an outbox). Both paths, and every
knob below, give the same state, escrow and stats, with one exception the
reference has too: the fused path gathers the outboxes shard-major, the
dispatch path row-major, so at R > 2 shards a cold-retry ring holds its
entries in another lane order, and where it overflows other entries drop.

* **stream** — one source draws the home-partitioned batches of every
  transaction type (the reference's numpy stream, so both packages run the
  same transactions);
* **mix** — ``payments``, ``reads`` (Order-Status and Stock-Level, through
  the RAMP reads) and ``deliveries`` add the rest of the five-transaction
  mix to New-Order, each batch in the reference's order: New-Order,
  Payment, the two reads, Delivery, then the drain when a window is full;
* **merge regime** — New-Order with restock, outboxes accumulated in a
  device window and drained by anti-entropy every ``merge_every`` batches;
* **escrow regime** — strict New-Order against the escrow shares (either
  layout: the engine's ``HotSetEscrow`` or dense ``EscrowCounter``), one
  strict drain per window, and the share refresh every ``refresh_every``
  drains or, with ``refresh_abort_rate``, as soon as the escrow abort rate
  since the last refresh crosses it (one host read per window);
* **cold-retry ring** — with ``retry_cap`` > 0 (sparse layout), each
  owner keeps the remote-cold entries its drain rejected in a bounded ring
  and re-presents them for up to ``retry_max`` windows, with optional
  owner-granted reservations (``retry_reserve``);
* **liveness** — a ``runtime.liveness.LeaseMonitor`` ticks once a drain
  window and its alive mask feeds that window's share refresh, so a
  replica that stops beating has its share reclaimed with no caller mask;
* **audit** — ``audit=True`` runs the consistency oracle on the final
  state;
* **observability** — ``obs`` (a ``repro_torch.obs.ObsSession``): tracer
  spans, the metrics lattice (fused path only) and the coordination
  ledger, read through ``obs.snapshot()`` after the run.

Stat accumulators stay on the device; the host reads them once at the end
(``legacy`` reads them every batch). ``run_closed_loop``,
``run_mixed_loop``, ``run_escrow_loop``, ``run_fused_loop`` and
``run_fused_escrow_loop`` are the reference's signature-compatible
wrappers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.planner import CoordClass
from repro_torch.device import synchronize

from . import tpcc
from .tpcc import NewOrderBatch, StockDelta, TPCCState


@dataclasses.dataclass
class RunStats:
    committed: int = 0
    batches: int = 0
    anti_entropy_rounds: int = 0
    aborted: int = 0
    refreshes: int = 0
    wall_seconds: float = 0.0

    @property
    def throughput(self) -> float:
        return self.committed / self.wall_seconds if self.wall_seconds else 0.0


@dataclasses.dataclass
class MixStats:
    """Closed-loop stats, with the reference's fields."""

    neworders: int = 0
    payments: int = 0
    order_statuses: int = 0
    stock_levels: int = 0
    deliveries: int = 0
    anti_entropy_rounds: int = 0
    reads_found: int = 0
    fractures_observed: int = 0
    lines_repaired: int = 0
    aborts: int = 0               # escrow regime: insufficient-share aborts
    refreshes: int = 0            # escrow regime: share-refresh rounds
    cold_rejects: int = 0         # sparse escrow: owner-rejected cold entries
    wall_seconds: float = 0.0

    @property
    def committed(self) -> int:
        return (self.neworders + self.payments + self.order_statuses
                + self.stock_levels + self.deliveries)

    @property
    def throughput(self) -> float:
        return self.committed / self.wall_seconds if self.wall_seconds else 0.0


class _OutboxWindow:
    """Fixed ``[rows, R]`` device buffer of per-batch outboxes; every drain
    reads the same flattened shape (unused rows stay ``valid=False``), in
    the entry order of concatenating the per-batch outboxes."""

    def __init__(self, delta: StockDelta, rows: int):
        self._buf = StockDelta(*(torch.zeros((rows,) + x.shape, dtype=x.dtype,
                                             device=x.device) for x in delta))
        self._n = 0

    def put(self, delta: StockDelta) -> None:
        for b, x in zip(self._buf, delta):
            b[self._n].copy_(x)
        self._n += 1

    def flat(self) -> StockDelta:
        return StockDelta(*(x.reshape(-1) for x in self._buf))

    def clear(self) -> None:
        self._buf.valid.zero_()
        self._n = 0

    def __len__(self) -> int:
        return self._n


def counters_to_stats(counters, *, anti_entropy_rounds: int,
                      wall_seconds: float, refreshes: int = 0,
                      cold_rejects: int = 0) -> MixStats:
    """One host read of the fused executor's ``MixCounters``."""
    c = [int(x.sum()) for x in torch.stack(list(counters)).cpu()]
    c = dict(zip(counters._fields, c))
    return MixStats(anti_entropy_rounds=anti_entropy_rounds,
                    refreshes=refreshes, cold_rejects=cold_rejects,
                    wall_seconds=wall_seconds, **c)


def generate_neworder_stream(engine, *, batch_per_shard: int,
                             n_batches: int, remote_frac: float,
                             rng: np.random.Generator, ts0: int = 0,
                             item_skew: float = 0.0) -> list[NewOrderBatch]:
    """Home-partitioned New-Order batches for a whole run."""
    batches = []
    for _ in range(n_batches):
        batch, ts0 = tpcc.neworder_batch(engine, rng, batch_per_shard,
                                         remote_frac, ts0, item_skew)
        batches.append(batch)
    return batches


def generate_mix_batches(engine, *, batch_per_shard: int,
                         n_batches: int, remote_frac: float = 0.01,
                         read_frac: float = 0.25, seed: int = 0,
                         item_skew: float = 0.0):
    """The five-transaction mix's batch streams (home-partitioned, one rng,
    the reference's draws in the reference's order): per batch a New-Order,
    a Payment, an Order-Status and a Stock-Level batch. Returns the four
    lists."""
    rng = np.random.default_rng(seed)
    per_shard_reads = max(1, int(batch_per_shard * read_frac))
    ts0 = 0
    no_batches, pay_batches, os_batches, sl_batches = [], [], [], []
    for _ in range(n_batches):
        batch, ts0 = tpcc.neworder_batch(engine, rng, batch_per_shard,
                                         remote_frac, ts0, item_skew)
        no_batches.append(batch)
        pay_batches.append(tpcc.home_partitioned(
            tpcc.generate_payment, rng, engine, batch_per_shard))
        os_batches.append(tpcc.home_partitioned(
            tpcc.generate_order_status, rng, engine, per_shard_reads))
        sl_batches.append(tpcc.home_partitioned(
            tpcc.generate_stock_level, rng, engine, per_shard_reads))
    return no_batches, pay_batches, os_batches, sl_batches


def _adaptive_refresh_due(aborts_since, txns_since, rate: float) -> bool:
    """Refresh iff ANY replica's escrow abort rate since the last refresh
    crossed ``rate``."""
    ab = np.asarray(aborts_since, np.int64)
    tx = np.maximum(1, np.asarray(txns_since, np.int64))
    return bool((ab > rate * tx).any())


def run_loop(engine, state: TPCCState, esc=None, *,
             batch_per_shard: int, n_batches: int,
             remote_frac: float = 0.01, merge_every: int = 8,
             refresh_every: int = 1, refresh_abort_rate: float | None = None,
             read_frac: float = 0.25, item_skew: float = 0.0, seed: int = 0,
             payments: bool = False, reads: bool = False,
             deliveries: bool = False, audit: bool = False, alive=None,
             fused: bool = True, legacy: bool = False, retry_cap: int = 0,
             retry_max: int = 0, retry=None, retry_reserve: int = 0,
             final_flush: bool = True, return_retry: bool = False,
             liveness=None, obs=None):
    """Drive the engine's plan-selected regime over a pre-generated stream.

    ``fused=True`` runs the fused executor: on the card each chunk of
    ``merge_every`` batches is one CUDA graph replay, then the drain (and
    refresh) at the host's cadence; on the CPU the chunk runs eagerly.
    ``fused=False`` runs batch by batch; ``legacy=True`` (which implies
    ``fused=False``) adds the seed's per-batch host reads of the stats and,
    in the merge regime, one anti-entropy call an outbox. Every mode gives
    the same state, escrow and stats (but for the retry ring's order at
    R > 2: see the module docstring).

    The state's tensors are updated in place. Batches are generated before
    the timed loop; a warm-up on copies (which builds the kernels on the
    card, and there captures the graphs) precedes it, so ``wall_seconds``
    covers all ``n_batches``.
    ``payments``, ``reads`` and ``deliveries`` add Payment, the two RAMP
    reads (``read_frac`` of the batch each) and Delivery to every batch.
    With ``reads`` the stream is the mix's (:func:`generate_mix_batches`),
    whose Payment batches are drawn whether or not ``payments`` is on, as in
    the reference. ``alive`` ([n_shards] mask) threads share reclamation
    into every refresh; ``liveness`` (a ``runtime.liveness.LeaseMonitor``)
    replaces it with a self-derived mask: the monitor ticks once per drain
    window of the escrow regime and its alive mask feeds that window's
    refresh.

    ``obs`` (a ``repro_torch.obs.ObsSession``) attaches the observability
    plane: tracer spans around the fused path's megastep, outbox-drain and
    share-refresh phases and around the audit; with metrics (fused path
    only), the lattice fed after the timed loop from the chunks it ran,
    which equals recording inline and launches nothing more in the loop;
    then ``obs.finish`` (one device-to-host copy of the lattice, and the
    coordination ledger when the session asks for one), so
    ``obs.snapshot()`` holds stats, latency quantiles, counters, item
    access, spans and ledger. Metrics are write-only: a metrics-on run
    ends bit-equal to a metrics-off run.

    The cold-retry ring (escrow regime, sparse layout): ``retry_cap`` > 0
    gives each owner a ring of that many lanes, whose owner-rejected
    remote-cold entries are re-presented for up to ``retry_max`` drain
    windows before they count as FINAL ``cold_rejects``;
    ``retry_reserve=1`` grants a last-chance entry a reservation out of
    the leftover stock instead. ``retry`` resumes a ring;
    ``final_flush=False`` leaves the entries still pending at the end in
    the returned ring instead of counting them as rejects (one host read);
    ``return_retry=True`` appends the ring to the return tuple.

    Returns ``(state, escrow-or-None, MixStats)``; ``stats.neworders``
    counts COMMITTED New-Orders (escrow aborts in ``stats.aborts``,
    owner-side cold rejections of the sparse layout in
    ``stats.cold_rejects``, 0 in the dense layout, which has no cold
    tier).
    """
    if legacy:
        fused = False
    if obs is not None and obs.wants_metrics and not fused:
        raise ValueError("on-device metrics require the fused executor "
                         "(fused=True); dispatch/legacy modes support "
                         "tracer spans only")
    escrow = engine.stock_regime is CoordClass.ESCROW
    if retry_cap > 0 and not escrow:
        raise ValueError("retry_cap > 0 requires the escrow regime "
                         "(the retry ring holds strict cold-tier entries)")
    if escrow and esc is None:
        esc = engine.init_escrow(state)
    q0 = state.s_quantity.clone() if audit else None
    if reads:
        no_b, pay_b, os_b, sl_b = generate_mix_batches(
            engine, batch_per_shard=batch_per_shard, n_batches=n_batches,
            remote_frac=remote_frac, read_frac=read_frac, seed=seed,
            item_skew=item_skew)
        if not payments:
            pay_b = None
    else:
        rng = np.random.default_rng(seed)
        no_b = generate_neworder_stream(
            engine, batch_per_shard=batch_per_shard, n_batches=n_batches,
            remote_frac=remote_frac, rng=rng, item_skew=item_skew)
        pay_b = [tpcc.home_partitioned(tpcc.generate_payment, rng, engine,
                                       batch_per_shard)
                 for _ in range(n_batches)] if payments else None
        os_b = sl_b = None
    knobs = dict(merge_every=merge_every, refresh_every=refresh_every,
                 refresh_abort_rate=refresh_abort_rate, deliveries=deliveries,
                 escrow=escrow, alive=alive, retry_cap=retry_cap,
                 retry_max=retry_max, retry=retry,
                 retry_reserve=retry_reserve, final_flush=final_flush,
                 liveness=liveness)
    if fused:
        state, esc, stats, retry = _fused_loop(
            engine, state, esc, no_b, pay_b, os_b, sl_b, obs=obs, **knobs)
    else:
        state, esc, stats, retry = _dispatch_loop(
            engine, state, esc, no_b, pay_b, os_b, sl_b,
            batch_per_shard=batch_per_shard, legacy=legacy, **knobs)
    if audit:
        from .audit import assert_audit
        with obs.span("audit") if obs is not None else \
                contextlib.nullcontext():
            if escrow:
                assert_audit(state, escrow=esc, initial_stock=q0,
                             strict_stock=True)
            else:
                assert_audit(state)
    if obs is not None:
        # one device-to-host copy of the lattice and the step -> seconds
        # calibration; the ledger counts its phases here, outside every
        # timed region
        obs.finish(engine, stats, total_steps=n_batches,
                   ledger_kw=dict(chunk_len=min(merge_every, n_batches),
                                  batch_per_shard=batch_per_shard,
                                  refresh_every=refresh_every,
                                  payments=payments or reads, reads=reads,
                                  metrics=obs.wants_metrics))
    if return_retry:
        return state, esc, stats, retry
    return state, esc, stats


def _fused_loop(engine, state, esc, no_b, pay_b, os_b, sl_b, *,
                merge_every, refresh_every, refresh_abort_rate, deliveries,
                escrow, alive, retry_cap=0, retry_max=0, retry=None,
                retry_reserve=0, final_flush=True, liveness=None, obs=None):
    """The fused path: the stream stacked into chunks of ``merge_every``
    batches on the device, then :class:`~repro_torch.txn.executor.
    FusedExecutor` (the engine's, built once)."""
    from .executor import get_fused_executor, stack_chunks

    chunks = stack_chunks(no_b, pay_b, os_b, sl_b, merge_every)
    ex = get_fused_executor(engine, ring_rows=merge_every,
                            deliveries=deliveries, retry_cap=retry_cap)
    if escrow:
        state, esc, counters, wall, refreshes, cold, retry = ex.run_escrow(
            state, esc, chunks, refresh_every=refresh_every,
            refresh_abort_rate=refresh_abort_rate, obs=obs, retry=retry,
            retry_max=retry_max, alive=alive, liveness=liveness,
            reserve=retry_reserve, final_flush=final_flush)
        return state, esc, counters_to_stats(
            counters, anti_entropy_rounds=len(chunks), wall_seconds=wall,
            refreshes=refreshes, cold_rejects=cold), retry
    state, counters, wall = ex.run(state, chunks, obs=obs)
    return state, None, counters_to_stats(
        counters, anti_entropy_rounds=len(chunks), wall_seconds=wall), retry


def _drain(engine, state, window: _OutboxWindow, escrow: bool, ring=None,
           retry_max=0, retry_reserve=0):
    """One drain of the window, through ``ring`` where there is one:
    (state, rejects or None, the ring after it)."""
    if ring is not None:
        state, ring, rej = engine.drain_strict_retry(
            state, window.flat(), ring, retry_max, retry_reserve)
        return state, rej, ring
    if escrow:
        return (*engine.drain_strict(state, window.flat()), None)
    return engine.anti_entropy(state, window.flat()), None, None


def _dispatch_loop(engine, state, esc, no_b, pay_b, os_b, sl_b, *,
                   batch_per_shard, merge_every, refresh_every,
                   refresh_abort_rate, deliveries, escrow, alive,
                   retry_cap=0, retry_max=0, retry=None, retry_reserve=0,
                   final_flush=True, liveness=None, legacy=False):
    """The per-batch dispatch path: one engine call per transaction type
    per batch. ``legacy`` reads the stats on the host every batch and, in
    the merge regime, drains each outbox in its own anti-entropy call (the
    escrow regime drains a whole window in every mode: the cold tier's
    all-or-nothing admission is defined over the window)."""
    ring = None                  # the live cold-retry ring, where there is one
    if escrow and retry_cap > 0:
        ring = engine.init_retry(retry_cap) if retry is None else retry
    n_batches = len(no_b)
    B = batch_per_shard * engine.n_shards
    reads = os_b is not None
    R = (max(1, os_b[0].w.shape[0] // engine.n_shards) * engine.n_shards
         if reads else 0)
    rows = min(merge_every, n_batches)
    dev = engine.device

    # -- warm-up on copies: builds the kernels; the timed loop covers every
    # batch
    warm = tpcc.copy_tree(state)
    if escrow:
        wesc = tpcc.copy_tree(esc)
        warm, wesc, outbox, _, _ = engine.neworder_escrow_step(warm, wesc,
                                                               no_b[0])
    else:
        warm, outbox, _ = engine.neworder_step(warm, no_b[0])
    if pay_b is not None:
        warm = engine.payment_step(warm, pay_b[0])
    if reads:
        engine.order_status_step(warm, os_b[0])
        engine.stock_level_step(warm, sl_b[0])
    if deliveries:
        warm, _ = engine.delivery_step(warm)
    per_outbox = legacy and not escrow
    window = _OutboxWindow(outbox, rows)
    if per_outbox:
        warm = engine.anti_entropy(warm, outbox)
    else:
        window.put(outbox)
        # the warm-up drains through a fresh ring, never the live one
        warm, _, _ = _drain(engine, warm, window, escrow,
                            None if ring is None
                            else engine.init_retry(retry_cap),
                            retry_max, retry_reserve)
    if escrow:
        engine.refresh_escrow(warm, wesc, alive)
    window.clear()
    synchronize(dev)
    del warm, outbox

    stats = MixStats()
    # legacy: Python ints, each add a host read (the seed's behaviour)
    host = (lambda x: int(x.sum())) if legacy else \
        (lambda x: x.sum().to(torch.int32))
    zero = 0 if legacy else torch.zeros((), dtype=torch.int32, device=dev)
    pending = []                 # legacy merge regime: the window's outboxes
    # on-device stat accumulators: the host reads them once, at the end
    commit_acc, rej_acc = zero, zero
    found_acc, fract_acc, rep_acc, del_acc = zero, zero, zero, zero
    adaptive = escrow and refresh_abort_rate is not None
    pr_commit = torch.zeros((engine.n_shards,), dtype=torch.int32,
                            device=dev) if adaptive else None
    commits_at_refresh = np.zeros(engine.n_shards, np.int64)
    txns_at_refresh = 0
    rounds = 0
    t0 = time.perf_counter()
    for i in range(n_batches):
        if escrow:
            state, esc, outbox, _, ok = engine.neworder_escrow_step(
                state, esc, no_b[i])
            commit_acc = commit_acc + host(ok)
            if adaptive:
                pr_commit = pr_commit + ok.reshape(engine.n_shards, -1).sum(
                    1).to(torch.int32)
        else:
            state, outbox, _ = engine.neworder_step(state, no_b[i])
            stats.neworders += B
        if per_outbox:
            pending.append(outbox)
        else:
            window.put(outbox)
        if pay_b is not None:
            state = engine.payment_step(state, pay_b[i])
            stats.payments += B
        if reads:
            os_res = engine.order_status_step(state, os_b[i])
            sl_res = engine.stock_level_step(state, sl_b[i])
            stats.order_statuses += R
            stats.stock_levels += R
            found_acc = found_acc + host(os_res.found)
            fract_acc = (fract_acc + host(os_res.found & (os_res.lines_read
                                                          < os_res.n_lines))
                         + host(sl_res.fractured - sl_res.repaired))
            rep_acc = rep_acc + host(os_res.repaired) + host(sl_res.repaired)
        if deliveries:
            state, delivered = engine.delivery_step(state)
            del_acc = del_acc + host(delivered)
        if max(len(window), len(pending)) == merge_every \
                or i == n_batches - 1:
            # one batched drain of the whole window (Definition 3:
            # convergence may lag the hot path, but must happen); legacy's
            # merge regime drains outbox by outbox
            if per_outbox:
                for ob in pending:
                    state = engine.anti_entropy(state, ob)
                pending = []
            else:
                state, rej, ring = _drain(engine, state, window, escrow,
                                          ring, retry_max, retry_reserve)
                if escrow:
                    rej_acc = rej_acc + host(rej)
                window.clear()
            stats.anti_entropy_rounds += 1
            rounds += 1
            if escrow:
                if liveness is not None:
                    # the self-derived mask: one monitor tick a drain
                    # window, feeding this window's refresh
                    alive = liveness.tick().astype(np.int32)
                if adaptive:
                    # the one host read adaptive control costs, per window
                    commits_now = pr_commit.cpu().numpy().astype(np.int64)
                    txns_now = batch_per_shard * (i + 1)
                    due = _adaptive_refresh_due(
                        (txns_now - txns_at_refresh)
                        - (commits_now - commits_at_refresh),
                        txns_now - txns_at_refresh, refresh_abort_rate)
                    if due:
                        commits_at_refresh = commits_now
                        txns_at_refresh = txns_now
                else:
                    due = rounds % refresh_every == 0
                if due:
                    esc = engine.refresh_escrow(state, esc, alive)
                    stats.refreshes += 1
    synchronize(dev)
    stats.wall_seconds = time.perf_counter() - t0
    if escrow:
        stats.neworders = int(commit_acc)
        stats.aborts = B * n_batches - stats.neworders
        stats.cold_rejects = int(rej_acc)
        if ring is not None and final_flush:
            # entries still in the ring never got their last window: they
            # count as final rejects (one host read)
            stats.cold_rejects += int(ring.valid.sum())
    stats.reads_found = int(found_acc)
    stats.fractures_observed = int(fract_acc)
    stats.lines_repaired = int(rep_acc)
    stats.deliveries = int(del_acc)
    return state, esc, stats, retry if ring is None else ring


# ---------------------------------------------------------------------------
# Signature-compatible wrappers (the public driver API)
# ---------------------------------------------------------------------------


def run_closed_loop(engine, state: TPCCState, *,
                    batch_per_shard: int, n_batches: int,
                    remote_frac: float = 0.01, merge_every: int = 8,
                    seed: int = 0, payments: bool = False,
                    deliveries: bool = False, fused: bool = True,
                    refresh_every: int = 1,
                    refresh_abort_rate: float | None = None,
                    item_skew: float = 0.0,
                    ) -> tuple[TPCCState, RunStats]:
    """New-Order closed loop (+ optional Payment/Delivery riders). On an
    escrow-regime engine the New-Order-only stream runs the strict hot path
    and the stats carry aborts/refreshes."""
    escrow = engine.stock_regime is CoordClass.ESCROW
    if escrow and (payments or deliveries):
        raise NotImplementedError(
            "escrow regime: use run_escrow_loop(mix=True) for the full "
            "transaction mix")
    state, _, m = run_loop(
        engine, state, batch_per_shard=batch_per_shard, n_batches=n_batches,
        remote_frac=remote_frac, merge_every=merge_every,
        refresh_every=refresh_every, refresh_abort_rate=refresh_abort_rate,
        item_skew=item_skew, seed=seed, payments=payments, reads=False,
        deliveries=deliveries, fused=fused)
    return state, RunStats(
        committed=m.neworders, batches=n_batches,
        anti_entropy_rounds=m.anti_entropy_rounds, aborted=m.aborts,
        refreshes=m.refreshes, wall_seconds=m.wall_seconds)


def run_mixed_loop(engine, state: TPCCState, *,
                   batch_per_shard: int, n_batches: int,
                   remote_frac: float = 0.01, merge_every: int = 8,
                   read_frac: float = 0.25, seed: int = 0,
                   fused: bool = True, legacy: bool = False,
                   refresh_every: int = 1,
                   refresh_abort_rate: float | None = None,
                   item_skew: float = 0.0, obs=None,
                   ) -> tuple[TPCCState, MixStats]:
    """The full five-transaction mix (New-Order, Payment, RAMP Order-Status
    / Stock-Level, Delivery) under the engine's plan-selected regime."""
    state, _, stats = run_loop(
        engine, state, batch_per_shard=batch_per_shard, n_batches=n_batches,
        remote_frac=remote_frac, merge_every=merge_every,
        refresh_every=refresh_every, refresh_abort_rate=refresh_abort_rate,
        read_frac=read_frac, item_skew=item_skew, seed=seed, payments=True,
        reads=True, deliveries=True, fused=fused, legacy=legacy, obs=obs)
    return state, stats


def run_escrow_loop(engine, state: TPCCState, esc=None, *,
                    batch_per_shard: int, n_batches: int,
                    remote_frac: float = 0.01, merge_every: int = 8,
                    refresh_every: int = 1,
                    refresh_abort_rate: float | None = None,
                    read_frac: float = 0.25, seed: int = 0, mix: bool = True,
                    fused: bool = True, legacy: bool = False,
                    item_skew: float = 0.0, obs=None,
                    ) -> tuple[TPCCState, object, MixStats]:
    """The escrow regime: strict-stock New-Order (plus the rest of the mix
    when ``mix=True``), one batched strict drain per ``merge_every``
    window, and the share refresh every ``refresh_every`` drains or when an
    abort rate crosses ``refresh_abort_rate``. Returns (state, escrow,
    MixStats): committed New-Orders in ``neworders``, insufficient-share
    aborts in ``aborts``, owner-side cold rejections in ``cold_rejects``."""
    engine._require_escrow()
    return run_loop(
        engine, state, esc, batch_per_shard=batch_per_shard,
        n_batches=n_batches, remote_frac=remote_frac,
        merge_every=merge_every, refresh_every=refresh_every,
        refresh_abort_rate=refresh_abort_rate, read_frac=read_frac,
        item_skew=item_skew, seed=seed, payments=mix, reads=mix,
        deliveries=mix, fused=fused, legacy=legacy, obs=obs)


def run_fused_loop(engine, state: TPCCState, *,
                   batch_per_shard: int, n_batches: int,
                   remote_frac: float = 0.01, merge_every: int = 8,
                   read_frac: float = 0.25, seed: int = 0,
                   ) -> tuple[TPCCState, MixStats]:
    """The full five-transaction mix on the fused executor (what
    ``run_mixed_loop(fused=True)`` runs)."""
    return run_mixed_loop(engine, state, batch_per_shard=batch_per_shard,
                          n_batches=n_batches, remote_frac=remote_frac,
                          merge_every=merge_every, read_frac=read_frac,
                          seed=seed, fused=True)


def run_fused_escrow_loop(engine, state: TPCCState, esc=None, *,
                          batch_per_shard: int, n_batches: int,
                          remote_frac: float = 0.01, merge_every: int = 8,
                          refresh_every: int = 1, read_frac: float = 0.25,
                          seed: int = 0, mix: bool = True,
                          refresh_abort_rate: float | None = None,
                          ) -> tuple[TPCCState, object, MixStats]:
    """The escrow regime on the fused executor (what
    ``run_escrow_loop(fused=True)`` runs)."""
    return run_escrow_loop(engine, state, esc,
                           batch_per_shard=batch_per_shard,
                           n_batches=n_batches, remote_frac=remote_frac,
                           merge_every=merge_every,
                           refresh_every=refresh_every,
                           refresh_abort_rate=refresh_abort_rate,
                           read_frac=read_frac, seed=seed, mix=mix,
                           fused=True)
