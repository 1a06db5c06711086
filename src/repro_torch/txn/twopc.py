"""Coordinated (serializable-style) baseline: per-batch synchronous 2PC, on
one card — the port of ``repro.txn.twopc``.

The paper's comparison point: "a traditional database system might use
locks to atomically control the visibility of these updates ...
[serializable approaches incur] throughput reductions ranging from
66-88%". The engine executes the *same* TPC-C effects but in the
coordination pattern a 2PC system pays for:

  1. the prepare phase: every shard broadcasts its full write intent (no
     outbox deferral), an all-gather, and remote stock updates apply
     synchronously inside the step;
  2. the commit barrier: a unanimous vote over the shards, a ``psum``;
  3. the wall clock additionally charges the atomic-commitment latency from
     the Monte-Carlo model (``txn/latency.py``) per conflicting round,
     since one device cannot reproduce network stalls.

The shards are those of ``txn/engine.py``: contiguous row blocks of the
global tables on one card, each body run on its own block, what crosses
shards counted by ``txn/collectives.py``. On one card the collectives move
no bytes between devices, so the coordination cost in time is the modeled
latency alone; their count is what the structural contrast reads.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize

from . import collectives, ramp, tpcc
from .drivers import RunStats
from .engine import (batch_parts, cat_shards, gather_and_apply_outbox,
                     proof_batch, shard_view, shards_of)
from .tpcc import NewOrderBatch, OrderStatusBatch, TPCCScale, TPCCState


@dataclasses.dataclass
class TwoPCEngine:
    """``strict_stock=True`` is the COORDINATION_REQUIRED fallback the
    planner selects for an opaque "serializable stock" invariant
    (``engine.plan_engine(stock_invariant="serial")``): every step
    broadcasts the full write intent, the global batch AND the global
    state, and replays the whole batch in timestamp order against the
    gathered stock as ONE escrow share (strict ``s_quantity >= 0``, atomic
    aborts, no restock); each shard keeps its slice of the verdicts, under
    the vote. Without it, the step is New-Order with restock and the
    synchronous apply of every remote stock update.

    The reference's shards each replay the gathered batch against the
    gathered state, R identical replays; on one card the gathered state is
    the global tables themselves, so the step replays once, in place, and
    copies no table. The replay admits through ``ops.escrow_admit`` (the
    escrow_admit kernel on the card), where the reference runs its
    sequential scan: the verdicts are bit-identical by the admission
    contract. ``device=None`` means the CUDA card and raises when there is
    none.
    """

    scale: TPCCScale
    strict_stock: bool = False
    device: torch.device | str | None = None
    n_shards: int = 1

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.w_per_shard = shards_of(self.scale, self.n_shards)

    def _parts(self, batch):
        return batch_parts(batch, self.n_shards)

    def _vote(self) -> torch.Tensor:
        """The commit barrier: every shard votes 1, summed over shards;
        true iff unanimous."""
        one = torch.ones((), dtype=torch.int32, device=self.device)
        return collectives.psum([one] * self.n_shards) == self.n_shards

    def step(self, state: TPCCState, batch: NewOrderBatch):
        """Returns (state, totals), or (state, committed mask) under
        ``strict_stock`` (aborted transactions have no effects). The state's
        tensors are updated in place."""
        if self.strict_stock:
            return self._step_strict(state, batch)
        W = self.w_per_shard
        deltas, totals = [], []
        for r, b in enumerate(self._parts(batch)):
            _, delta, total = tpcc.apply_neworder(
                shard_view(state, r, W), b, self.scale, w_lo=r * W,
                w_hi=(r + 1) * W)
            deltas.append(delta)
            totals.append(total)
        # prepare phase: every remote write is routed to its owner and
        # applies synchronously
        state = gather_and_apply_outbox(state, cat_shards(deltas), W,
                                        self.n_shards)
        # commit barrier: unanimous vote
        committed = self._vote()
        return state, torch.where(committed, cat_shards(totals), 0.0)

    def _step_strict(self, state: TPCCState, batch: NewOrderBatch):
        W = self.w_per_shard
        # prepare phase: broadcast the full write intent, the global batch
        # and the global state; the shards' views gather back into the
        # global tables, with no copy
        g_batch = collectives.all_gather_tree(self._parts(batch))
        g_state = collectives.all_gather_tree(
            [shard_view(state, r, W) for r in range(self.n_shards)])
        # serializable execution: the WHOLE batch in timestamp order with
        # the entire stock as one escrow share, once (the reference's R
        # replicas replay it identically)
        _, _, _, _, ok = tpcc.apply_neworder_escrow(
            g_state, g_state.s_quantity, torch.zeros_like(g_state.s_quantity),
            g_batch, self.scale, w_lo=0, w_hi=self.scale.n_warehouses,
            replica=0, num_replicas=1, admission="kernel")
        # commit: each shard keeps its slice of the verdicts, under the
        # unanimous vote
        return state, ok & self._vote()

    def read_step(self, state: TPCCState, batch: OrderStatusBatch
                  ) -> ramp.OrderStatusResult:
        """Order-Status under 2PC-style synchronized visibility: every
        shard announces its read intent and waits for the global grant (an
        all-gather), reads its slice through the fused read, then the
        release vote (a ``psum``) gates the results: ``found & ok``."""
        parts = self._parts(batch)
        granted = collectives.all_gather(
            [torch.ones((b.w.shape[0],), dtype=torch.int32,
                        device=self.device) for b in parts])
        res = cat_shards([ramp.apply_order_status(
            shard_view(state, r, self.w_per_shard), b,
            w_lo=r * self.w_per_shard) for r, b in enumerate(parts)])
        ok = self._vote() & (granted.sum() > 0)
        return res._replace(found=res.found & ok)

    def hot_path_collectives(self, batch_per_shard: int = 8
                             ) -> collectives.CollectiveStats:
        """The collectives of one step at ``batch_per_shard``, on
        ``init_state``."""
        state = tpcc.init_state(self.scale, device=self.device)
        batch = proof_batch(self, batch_per_shard)
        with collectives.counted() as stats:
            self.step(state, batch)
        return stats

    def read_path_collectives(self, batch_per_shard: int = 8
                              ) -> collectives.CollectiveStats:
        """The collectives of one ``read_step`` at ``batch_per_shard``, on
        ``init_state``."""
        state = tpcc.init_state(self.scale, device=self.device)
        b = proof_batch(self, batch_per_shard)
        with collectives.counted() as stats:
            self.read_step(state, OrderStatusBatch(b.w, b.d, b.c))
        return stats


def _conflict_rounds(batch: NewOrderBatch, districts: int) -> int:
    """Transactions on the same district conflict (they contend for the
    sequential o_id); a serializable system runs them as SEQUENTIAL
    atomic-commitment rounds, so a batch costs max-txns-per-district rounds
    of commit latency (the paper's §6.1 worst-case accounting). Reads the
    batch on the host."""
    key = batch.w.cpu().numpy() * districts + batch.d.cpu().numpy()
    _, counts = np.unique(key, return_counts=True)
    return int(counts.max()) if counts.size else 1


def run_closed_loop_2pc(engine: TwoPCEngine, state: TPCCState, *,
                        batch_per_shard: int, n_batches: int,
                        remote_frac: float = 0.01, seed: int = 0,
                        commit_latency_s: float = 0.0,
                        item_skew: float = 0.0):
    """Drive the coordinated baseline. Per batch it charges
    ``commit_latency_s`` x (conflicting rounds on the hottest district):
    the serialization the coordination-avoiding engine's batched
    increment-and-get makes unnecessary. Under ``strict_stock`` the step
    returns committed masks; aborted (insufficient-stock) transactions are
    reported in ``stats.aborted``.

    The reference's schedule is kept: under ``strict_stock`` a warm-up on a
    copy, then all ``n_batches`` timed; without it the warm-up runs batch
    0 on the real state and batches 1..n-1 are timed. The batches are drawn
    on the host (the reference's stream) and their rounds counted there,
    before the timed window. Returns (state, RunStats)."""
    rng = np.random.default_rng(seed)
    B = batch_per_shard * engine.n_shards
    batches, rounds = [], []
    ts0 = 0
    for _ in range(n_batches):
        parts = []
        for s in range(engine.n_shards):
            parts.append(tpcc.generate_neworder(
                rng, engine.scale, batch_per_shard, remote_frac=remote_frac,
                w_lo=s * engine.w_per_shard,
                w_hi=(s + 1) * engine.w_per_shard, ts0=ts0,
                item_skew=item_skew, device="cpu"))
            ts0 += batch_per_shard
        host = NewOrderBatch(*(torch.cat(xs) for xs in zip(*parts)))
        rounds.append(_conflict_rounds(host, engine.scale.districts))
        batches.append(NewOrderBatch(*(x.to(engine.device) for x in host)))

    if engine.strict_stock:
        # warmup on a copy so every batch is timed exactly once
        warm, _ = engine.step(tpcc.copy_tree(state), batches[0])
        synchronize(engine.device)
        del warm

        stats = RunStats()
        commit_acc = torch.zeros((), dtype=torch.int32, device=engine.device)
        latency_charged = 0.0
        t0 = time.perf_counter()
        for i in range(n_batches):
            state, ok = engine.step(state, batches[i])
            commit_acc = commit_acc + ok.sum().to(torch.int32)
            stats.batches += 1
            latency_charged += commit_latency_s * rounds[i]
        synchronize(engine.device)
        stats.wall_seconds = (time.perf_counter() - t0) + latency_charged
        stats.committed = int(commit_acc)
        stats.aborted = B * n_batches - stats.committed
        return state, stats

    state, _ = engine.step(state, batches[0])  # warmup
    synchronize(engine.device)

    stats = RunStats()
    latency_charged = 0.0
    t0 = time.perf_counter()
    for i in range(1, n_batches):
        state, _ = engine.step(state, batches[i])
        stats.committed += B
        stats.batches += 1
        latency_charged += commit_latency_s * rounds[i]
    synchronize(engine.device)
    stats.wall_seconds = (time.perf_counter() - t0) + latency_charged
    return state, stats
