"""Coordinated (serializable-style) baseline: per-batch synchronous 2PC, on
one card — the port of ``repro.txn.twopc``.

The paper's comparison point: "a traditional database system might use
locks to atomically control the visibility of these updates ...
[serializable approaches incur] throughput reductions ranging from
66-88%". The engine executes the *same* TPC-C effects but in the
coordination pattern a 2PC system pays for:

  1. the prepare phase: every shard broadcasts its full write intent (no
     outbox deferral) and remote stock updates apply synchronously inside
     the step;
  2. the commit barrier: a unanimous vote over the shards;
  3. the wall clock additionally charges the atomic-commitment latency from
     the Monte-Carlo model (``txn/latency.py``) per conflicting round,
     since one device cannot reproduce network stalls.

On one shard the all-gathers and the vote are the identity, so the step
bodies below are the reference's with them left out; ``n_shards > 1``
raises. Its coordination cost on one card is the modeled latency alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize

from . import ramp, tpcc
from .drivers import RunStats, _copy
from .engine import _one_shard
from .tpcc import NewOrderBatch, OrderStatusBatch, TPCCScale, TPCCState

_COLLECTIVES = ("the structural proof that the 2PC paths carry collectives "
                "comes with multi-shard state, ROADMAP Queue A item 4; one "
                "shard has none")


@dataclasses.dataclass
class TwoPCEngine:
    """``strict_stock=True`` is the COORDINATION_REQUIRED fallback the
    planner selects for an opaque "serializable stock" invariant
    (``engine.plan_engine(stock_invariant="serial")``): every step replays
    the whole batch in timestamp order against the global stock as ONE
    escrow share (strict ``s_quantity >= 0``, atomic aborts, no restock).
    Without it, the step is New-Order with restock and the synchronous
    apply of every remote stock update.

    The strict step admits through ``ops.escrow_admit`` (the escrow_admit
    kernel on the card), where the reference runs its sequential scan: the
    verdicts are bit-identical by the admission contract.
    ``device=None`` means the CUDA card and raises when there is none.
    """

    scale: TPCCScale
    strict_stock: bool = False
    device: torch.device | str | None = None
    n_shards: int = 1

    def __post_init__(self):
        self.device = resolve_device(self.device)
        _one_shard(self.n_shards)
        self.w_per_shard = self.scale.n_warehouses

    def step(self, state: TPCCState, batch: NewOrderBatch):
        """Returns (state, totals), or (state, committed mask) under
        ``strict_stock`` (aborted transactions have no effects). The state's
        tensors are updated in place."""
        if self.strict_stock:
            return self._step_strict(state, batch)
        state, delta, total = tpcc.apply_neworder(
            state, batch, self.scale, w_lo=0, w_hi=self.w_per_shard)
        # prepare phase: every remote write applies synchronously at its
        # owner (the gathered outbox of one shard is its own)
        dst = delta.dst_w
        own = delta.valid & (dst >= 0) & (dst < self.w_per_shard)
        state = tpcc.apply_stock_updates(state, dst, delta.i_id, delta.qty,
                                         own, torch.ones_like(own))
        return state, total

    def _step_strict(self, state: TPCCState, batch: NewOrderBatch):
        # serializable execution: the WHOLE batch in timestamp order with
        # the entire stock as one escrow share; the gathered state of one
        # shard is its own, so no table is copied
        state, _, _, _, ok = tpcc.apply_neworder_escrow(
            state, state.s_quantity, torch.zeros_like(state.s_quantity),
            batch, self.scale, w_lo=0, w_hi=self.scale.n_warehouses,
            replica=0, num_replicas=1, admission="kernel")
        return state, ok

    def read_step(self, state: TPCCState, batch: OrderStatusBatch
                  ) -> ramp.OrderStatusResult:
        """Order-Status under 2PC-style synchronized visibility (on one
        shard the lock grant and the release vote are the identity): the
        RAMP read, through the fused read."""
        return ramp.apply_order_status(state, batch, w_lo=0)

    def hot_path_collectives(self, batch_per_shard: int = 8):
        raise NotImplementedError(_COLLECTIVES)

    def read_path_collectives(self, batch_per_shard: int = 8):
        raise NotImplementedError(_COLLECTIVES)


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
        warm, _ = engine.step(_copy(state), batches[0])
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
