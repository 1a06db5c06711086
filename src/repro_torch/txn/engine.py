"""Coordination-avoiding TPC-C engine on one card (paper §6.2).

The port of ``repro.txn.engine``. The state is the global ``[W, ...]``
tables on the card; shard r of ``n_shards`` (R) is the contiguous row
block ``[r * Wps, (r + 1) * Wps)`` of every table (:func:`shard_view`,
``Wps = W / R``), which is what the reference's warehouse-sharded arrays
are when gathered. Each step runs the reference's per-shard body once a
shard, on that shard's view and its part of the batch, with the
reference's ``w_lo``, ``w_hi``, ``replica`` and ``num_replicas``; the
bodies update the views in place, so the global tables change. Outputs
concatenate shard-major, as the reference's ``out_specs`` do.

* **hot path** — :meth:`Engine.neworder_step` (merge regime) and
  :meth:`Engine.neworder_escrow_step` (escrow regime) run New-Order against
  the local state; remote stock updates are emitted into an outbox;
* **anti-entropy** — :meth:`Engine.anti_entropy` / :meth:`Engine.drain_strict`
  gather the outboxes and apply the entries each owner holds;
* **escrow refresh** — :meth:`Engine.refresh_escrow`, the regime's amortized
  coordination point, re-partitions the stock into shares (a ``psum`` of
  the hot cells' in the sparse layout, a gather of every cell's in the
  dense one);
* **the rest of the mix** — :meth:`Engine.payment_step`,
  :meth:`Engine.delivery_step` and the RAMP reads
  :meth:`Engine.order_status_step` and :meth:`Engine.stock_level_step`.

What crosses shards goes through ``txn/collectives.py``, which counts it.
The proofs (:meth:`Engine.prove_coordination_free`,
:meth:`Engine.prove_read_coordination_free`) read those counts and run each
shard's body on a state whose other slices are scrambled: the structural
form of the reference's HLO proofs.

:func:`plan_engine` is the plan-driven factory: it returns the synchronous
2PC baseline (``txn.twopc.TwoPCEngine``) where the plan demands
coordination, and :class:`Engine` elsewhere.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.analyzer import Strategy
from repro_torch.core.lattice import EscrowCounter, HotSetEscrow
from repro_torch.core.planner import CoordClass, plan as plan_specs
from repro_torch.device import resolve_device

from . import collectives, ramp, tpcc
from .tpcc import (NewOrderBatch, OrderStatusBatch, PaymentBatch, StockDelta,
                   StockLevelBatch, TPCCScale, TPCCState, tpcc_state_specs)


def shards_of(scale: TPCCScale, n_shards: int) -> int:
    """Warehouses a shard; ``ValueError`` unless ``n_shards`` divides W."""
    if n_shards < 1 or scale.n_warehouses % n_shards:
        raise ValueError(f"{scale.n_warehouses} warehouses not divisible by "
                         f"{n_shards} shards")
    return scale.n_warehouses // n_shards


def _rows(x: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Rows ``[r * n, (r + 1) * n)`` of ``x``: a view that writes through
    (asserted contiguous, so no reshape or indexed write copies it)."""
    v = x[r * n:(r + 1) * n]
    if not v.is_contiguous():
        raise ValueError("a shard view must be contiguous: pass tables "
                         "through Engine.shard_state")
    return v


def shard_view(state, r: int, rows: int):
    """Shard r's block of every table (or batch field): rows
    ``[r * rows, (r + 1) * rows)``, views that write through."""
    return type(state)(*(_rows(x, r, rows) for x in state))


def batch_parts(batch, n_shards: int) -> list:
    """A home-partitioned batch's per-shard parts (shard-major rows, as
    the reference's ``batch_spec`` hands them out): views."""
    rows = batch[0].shape[0] // n_shards
    return [shard_view(batch, r, rows) for r in range(n_shards)]


def proof_batch(engine, batch_per_shard: int) -> NewOrderBatch:
    """The proofs' New-Order batch: home-partitioned, half the lines
    remote, from a fixed seed."""
    return tpcc.neworder_batch(engine, np.random.default_rng(0),
                               batch_per_shard, 0.5, 0)[0]


def cat_shards(parts):
    """Per-shard outputs (tensors or tuples of them) concatenated
    shard-major, as the reference's ``out_specs`` lay them out; no
    collective. One shard's output is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return type(parts[0])(*(torch.cat(xs) for xs in zip(*parts)))


def _scramble(t, keep: int, rows: int, gen: torch.Generator,
              skip: tuple[str, ...] = ()):
    """A copy of ``t`` whose row blocks other than ``keep`` (of ``rows``
    rows each) hold seeded noise; the fields in ``skip`` are copied as
    they are."""
    out = tpcc.copy_tree(t)
    for f, x in zip(out._fields, out):
        if f in skip:
            continue
        for r in range(x.shape[0] // rows):
            if r == keep:
                continue
            v = x[r * rows:(r + 1) * rows]
            noise = torch.rand(v.shape, generator=gen, device=v.device)
            if v.dtype == torch.bool:
                v.copy_(noise < 0.5)
            else:
                v.copy_((noise * 1000.0 - 500.0).to(v.dtype))
    return out


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    return [t for y in x for t in _leaves(y)]


def _differs(a, b) -> list[str]:
    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


@dataclasses.dataclass
class Engine:
    """TPC-C on one card, regime chosen by the coordination plan, the
    warehouses in ``n_shards`` shards.

    At construction the engine runs ``core.planner.plan()`` over the TPC-C
    state specs; the verdict for STOCK.S_QUANTITY selects the regime:
    COORDINATION_FREE -> merge (outbox + anti-entropy), ESCROW -> strict
    stock over escrow shares, COORDINATION_REQUIRED -> refused
    (:func:`plan_engine` falls back to the 2PC baseline).

    ``escrow_layout`` picks the ESCROW regime's state: "sparse" (default),
    a ``HotSetEscrow`` over the top-K contended cells (``[K]`` keys,
    ``[R, K]`` shares and spent) with the cold tail owner-routed through
    the outbox; "dense", the ``[R, W, I]`` ``EscrowCounter`` (every replica
    a share of every cell), the comparison baseline. Replica r admits
    against ``shares[r] - spent[r]`` only. ``admission`` ("auto" | "scan" |
    "kernel") and ``effects`` ("fused" | "scan") pick the escrow regime's
    strategies (both layouts), with bit-identical results.
    ``device=None`` means the CUDA card and raises when there is none.
    """

    scale: TPCCScale
    stock_invariant: str = "restock"
    escrow_layout: str = "sparse"
    hot_items: int | None = None
    admission: str = "auto"
    effects: str = "fused"
    device: torch.device | str | None = None
    n_shards: int = 1

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.w_per_shard = shards_of(self.scale, self.n_shards)

        self.plan = plan_specs(tpcc_state_specs(self.stock_invariant))
        self.stock_regime = self.plan.entry("stock.s_quantity").coord_class
        if self.stock_regime is CoordClass.REQUIRED:
            raise ValueError(
                "planner classified stock.s_quantity as "
                "COORDINATION_REQUIRED — this coordination-avoiding engine "
                "cannot satisfy it; use plan_engine() to fall back to the "
                "synchronous TwoPCEngine baseline")
        if (self.plan.entry("district.d_next_o_id").strategy
                is not Strategy.DEFERRED_ASSIGNMENT):
            raise RuntimeError("district.d_next_o_id must plan as deferred "
                               "assignment")
        self._restock = self.stock_regime is CoordClass.FREE

        if self.escrow_layout not in ("sparse", "dense"):
            raise ValueError(f"unknown escrow_layout {self.escrow_layout!r};"
                             f" choose 'sparse' or 'dense'")
        if self.admission not in tpcc.ADMISSION_MODES:
            raise ValueError(f"unknown admission {self.admission!r}; "
                             f"choose from {tpcc.ADMISSION_MODES}")
        if self.effects not in tpcc.EFFECTS_MODES:
            raise ValueError(f"unknown effects {self.effects!r}; "
                             f"choose from {tpcc.EFFECTS_MODES}")
        if self.hot_items is None:
            self.hot_items = tpcc.default_hot_items(self.scale)
        if self.stock_regime is CoordClass.ESCROW:
            self._hot_keys_np = tpcc.select_hot_cells(self.scale,
                                                      self.hot_items)
            self.hot_keys = torch.from_numpy(self._hot_keys_np).to(
                self.device)

    # -- helpers --------------------------------------------------------------

    def shard_state(self, state: TPCCState) -> TPCCState:
        """The global tables on this engine's device, contiguous (so every
        shard view writes through)."""
        return TPCCState(*(x.to(self.device).contiguous() for x in state))

    def shard_view(self, state: TPCCState, r: int) -> TPCCState:
        """Shard r's warehouses of every table."""
        return shard_view(state, r, self.w_per_shard)

    def _bounds(self, r: int) -> tuple[int, int]:
        return r * self.w_per_shard, (r + 1) * self.w_per_shard

    def _parts(self, batch):
        return batch_parts(batch, self.n_shards)

    def _require_escrow(self):
        if self.stock_regime is not CoordClass.ESCROW:
            raise RuntimeError(
                f"stock regime is {self.stock_regime.value!r}, not escrow — "
                f"construct the engine with stock_invariant='strict'")

    # -- per-shard bodies (each reads and writes shard r's slice only) --------

    def _neworder_shard(self, state, r, batch):
        w_lo, w_hi = self._bounds(r)
        _, delta, total = tpcc.apply_neworder(
            self.shard_view(state, r), batch, self.scale, w_lo=w_lo,
            w_hi=w_hi, replica=r, num_replicas=self.n_shards)
        return delta, total

    def _neworder_escrow_shard(self, state, esc, r, batch):
        w_lo, w_hi = self._bounds(r)
        kw = dict(w_lo=w_lo, w_hi=w_hi, replica=r,
                  num_replicas=self.n_shards, admission=self.admission,
                  effects=self.effects)
        view = self.shard_view(state, r)
        if self.escrow_layout == "sparse":
            _, spent, delta, total, ok = tpcc.apply_neworder_escrow_sparse(
                view, esc.keys, esc.shares[r], esc.spent[r], batch,
                self.scale, **kw)
        else:
            _, spent, delta, total, ok = tpcc.apply_neworder_escrow(
                view, esc.shares[r], esc.spent[r], batch, self.scale, **kw)
        esc.spent[r].copy_(spent)
        return delta, total, ok

    def _order_status_shard(self, state, r, batch):
        return ramp.apply_order_status(self.shard_view(state, r), batch,
                                       w_lo=self._bounds(r)[0])

    def _stock_level_shard(self, state, r, batch):
        return ramp.apply_stock_level(self.shard_view(state, r), batch,
                                      self.scale, w_lo=self._bounds(r)[0])

    # -- merge regime ---------------------------------------------------------

    def neworder_step(self, state: TPCCState, batch: NewOrderBatch):
        """Hot path: returns (state, outbox, totals). No collective."""
        outs = [self._neworder_shard(state, r, b)
                for r, b in enumerate(self._parts(batch))]
        return (state, cat_shards([o[0] for o in outs]),
                cat_shards([o[1] for o in outs]))

    def anti_entropy(self, state: TPCCState, outbox: StockDelta) -> TPCCState:
        """Gather every shard's outbox and apply the entries each owner
        holds (with restock in the merge regime)."""
        return gather_and_apply_outbox(state, outbox, self.w_per_shard,
                                       self.n_shards, restock=self._restock)

    def owned_lanes(self, outbox) -> torch.Tensor:
        """The lanes of ``outbox`` (any shape: a flat outbox or the
        executor's ring) that carry work in a drain: every owner's mask
        summed on the device (0-d int64). Each owner's stock scatter takes
        all ``n_shards * numel`` lanes, the others adding zero."""
        return torch.stack([_owned_by(outbox, r, self.w_per_shard).sum()
                            for r in range(self.n_shards)]).sum()

    # -- the rest of the five-transaction mix ---------------------------------

    def payment_step(self, state: TPCCState, batch: PaymentBatch,
                     rounds: int | None = None) -> TPCCState:
        """Payment on every shard; ``rounds`` as ``tpcc.apply_payment``'s
        (None: each shard reads its batch's depth on the host)."""
        for r, b in enumerate(self._parts(batch)):
            tpcc.apply_payment(self.shard_view(state, r), b,
                               w_lo=self._bounds(r)[0], rounds=rounds)
        return state

    def delivery_step(self, state: TPCCState
                      ) -> tuple[TPCCState, torch.Tensor]:
        """Deliver one order in every district that has one (carrier 1).
        Returns (state, per-shard delivered-order counts [n_shards] int32)."""
        counts = []
        for r in range(self.n_shards):
            view = self.shard_view(state, r)
            counts.append(view.no_valid.any(2).sum().to(torch.int32)
                          .reshape(1))
            tpcc.apply_delivery(view, 1, 0)
        return state, cat_shards(counts)

    def order_status_step(self, state: TPCCState, batch: OrderStatusBatch
                          ) -> ramp.OrderStatusResult:
        """RAMP read path: atomic visibility, through the fused read. No
        collective."""
        return cat_shards([self._order_status_shard(state, r, b)
                     for r, b in enumerate(self._parts(batch))])

    def stock_level_step(self, state: TPCCState, batch: StockLevelBatch
                         ) -> ramp.StockLevelResult:
        """RAMP read path: atomic visibility. No collective."""
        return cat_shards([self._stock_level_shard(state, r, b)
                     for r, b in enumerate(self._parts(batch))])

    # -- escrow regime (plan-selected; paper §8) ------------------------------

    def init_escrow(self, state: TPCCState):
        """Shares partitioning the current stock among the replicas: a
        ``HotSetEscrow`` over the K hot cells (sparse layout) or the
        ``[R, W, I]`` ``EscrowCounter`` (dense layout)."""
        self._require_escrow()
        if self.escrow_layout == "sparse":
            budgets = state.s_quantity.reshape(-1)[self.hot_keys.long()]
            return HotSetEscrow.make(self.n_shards, self.hot_keys, budgets)
        shares = tpcc.make_escrow_shares(state.s_quantity, self.n_shards)
        return EscrowCounter(shares, torch.zeros_like(shares))

    def neworder_escrow_step(self, state: TPCCState, esc, batch: NewOrderBatch):
        """Strict-stock New-Order with local escrow admission: replica r
        spends ``esc.spent[r]`` (written in place). Returns (state, esc,
        outbox, totals, committed mask). No collective."""
        self._require_escrow()
        outs = [self._neworder_escrow_shard(state, esc, r, b)
                for r, b in enumerate(self._parts(batch))]
        return (state, esc,
                *(cat_shards([o[i] for o in outs]) for i in range(3)))

    def refresh_escrow(self, state: TPCCState, esc, alive=None):
        """Re-partition the post-drain stock into fresh shares (the hot
        cells' in the sparse layout, every cell's in the dense one), written
        into ``esc``'s own tensors, which are returned: whatever holds them
        (a captured CUDA graph of the fused executor) reads the new shares.
        ``alive`` ([n_shards] mask, default all live) gives dead replicas'
        headroom to the survivors."""
        self._require_escrow()
        if alive is None:
            alive = torch.ones((self.n_shards,), dtype=torch.int32,
                               device=self.device)
        if self.escrow_layout == "sparse":
            new = gather_and_refresh_hot_shares(
                state, esc.keys, self.n_shards, self.scale.n_items,
                self.w_per_shard, alive=alive)
        else:
            new = gather_and_refresh_shares(state, self.n_shards,
                                            self.w_per_shard, alive=alive)
        esc.shares.copy_(new.shares)
        esc.spent.zero_()
        return esc

    def drain_strict(self, state: TPCCState, outbox: StockDelta
                     ) -> tuple[TPCCState, torch.Tensor]:
        """Strict anti-entropy, without restock. Sparse layout: hot entries
        apply unconditionally, cold entries under the owner's per-cell
        all-or-nothing admission. Dense layout: every entry was admitted
        against a share upstream and applies; it has no cold tier. Returns
        (state, cold-reject counts [n_shards])."""
        self._require_escrow()
        if self.escrow_layout == "sparse":
            return gather_and_apply_outbox_strict(
                state, outbox, self.hot_keys, self.w_per_shard,
                self.scale.n_items, self.n_shards)
        state = gather_and_apply_outbox(state, outbox, self.w_per_shard,
                                        self.n_shards, restock=False)
        return state, torch.zeros((self.n_shards,), dtype=torch.int32,
                                  device=self.device)

    def init_retry(self, retry_cap: int) -> tpcc.RetryState:
        """Every owner's empty bounded retry ring (``[n_shards, retry_cap]``
        lanes, row r owner r's) for :meth:`drain_strict_retry`."""
        self._require_escrow()
        ring = tpcc.empty_retry(retry_cap, self.device)
        return tpcc.RetryState(*(x[None].repeat(self.n_shards, 1)
                                 for x in ring))

    def drain_strict_retry(self, state: TPCCState, outbox: StockDelta,
                           retry: tpcc.RetryState, retry_max=0, reserve=0
                           ) -> tuple[TPCCState, tpcc.RetryState,
                                      torch.Tensor]:
        """:meth:`drain_strict` with the bounded cold-retry ring: an
        owner-rejected remote-cold entry is re-presented for up to
        ``retry_max`` drain windows before it counts as a FINAL reject;
        ``reserve`` > 0 turns last-chance losers into owner-granted
        reservations (tpcc.apply_stock_updates_strict_tiered_retry). Both
        are ints or 0-d tensors. Returns (state, retry', final-reject
        counts [n_shards]). Sparse layout only: dense has no cold tier."""
        self._require_escrow()
        if self.escrow_layout != "sparse":
            raise RuntimeError("drain_strict_retry requires the sparse "
                               "(two-tier) escrow layout")
        return gather_and_apply_outbox_strict_retry(
            state, outbox, retry, self.hot_keys, self.w_per_shard,
            self.scale.n_items, self.n_shards, retry_max, reserve)

    def escrow_bytes_per_device(self) -> dict:
        """Per-device escrow residency of this engine's layout vs dense."""
        self._require_escrow()
        out = tpcc.escrow_layout_bytes(self.scale, self.hot_items)
        out["layout"] = self.escrow_layout
        out["bytes_per_device"] = out[f"{self.escrow_layout}_bytes_per_device"]
        return out

    # -- structural proofs ----------------------------------------------------


    def _assert_shard_local(self, what: str, body, state, esc=None,
                            read_only: bool = False) -> None:
        """For every shard r, ``body(state, esc, r)`` runs on a copy of
        ``state`` and on a copy whose other shards' slices (and other
        replicas' escrow rows) hold noise. Both runs must return the same
        outputs and leave the same slice r (with ``read_only``: slice r as
        it was), and the noisy slices must come back bit-unchanged."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        W = self.w_per_shard
        for r in range(self.n_shards):
            clean = tpcc.copy_tree(state)
            e_clean = None if esc is None else tpcc.copy_tree(esc)
            want = _leaves(body(clean, e_clean, r))
            dirty = _scramble(state, r, W, gen)
            e_dirty = (None if esc is None
                       else _scramble(esc, r, 1, gen, skip=("keys",)))
            before = tpcc.copy_tree(dirty)
            e_before = None if esc is None else tpcc.copy_tree(e_dirty)
            got = _leaves(body(dirty, e_dirty, r))
            bad = [f"output {i}" for i, (x, y) in enumerate(zip(want, got))
                   if not torch.equal(x, y)]
            bad += [f"slice {r} of {f}" for f in _differs(
                self.shard_view(clean, r), self.shard_view(dirty, r))]
            if read_only:
                bad += [f"read wrote {f}" for f in _differs(state, clean)]
            bad += [f"slice {s} of {f}" for s in range(self.n_shards)
                    if s != r for f in _differs(self.shard_view(before, s),
                                                self.shard_view(dirty, s))]
            if esc is not None:
                for f, x, y, b in zip(esc._fields, e_clean, e_dirty,
                                      e_before):
                    if f == "keys":
                        bad += [] if torch.equal(x, y) else ["escrow keys"]
                        continue
                    bad += [f"escrow {f}[{s}]" for s in range(self.n_shards)
                            if not torch.equal(x[s] if s == r else b[s],
                                               y[s])]
            if bad:
                raise AssertionError(f"{what}: shard {r}'s body depends on "
                                     f"or writes outside its slice: {bad}")

    def prove_coordination_free(self, batch_per_shard: int = 8) -> str:
        """Definition 5, structurally: the plan-selected regime's hot step
        calls no collective, and each shard's body reads and writes its
        own slice only (:meth:`_assert_shard_local`), on ``init_state``.
        Returns the stats line."""
        state = tpcc.init_state(self.scale, device=self.device)
        batch = proof_batch(self, batch_per_shard)
        parts = self._parts(batch)
        if self.stock_regime is CoordClass.ESCROW:
            what = "TPC-C escrow New-Order hot path"
            esc = self.init_escrow(state)
            with collectives.counted() as stats:
                self.neworder_escrow_step(tpcc.copy_tree(state),
                                          tpcc.copy_tree(esc), batch)
            body = lambda st, e, r: self._neworder_escrow_shard(  # noqa: E731
                st, e, r, parts[r])
        else:
            what = "TPC-C New-Order hot path"
            esc = None
            with collectives.counted() as stats:
                self.neworder_step(tpcc.copy_tree(state), batch)
            body = lambda st, e, r: self._neworder_shard(  # noqa: E731
                st, r, parts[r])
        if stats.total_ops:
            raise AssertionError(f"coordination-free path contains "
                                 f"collectives in {what}: "
                                 f"{stats.describe()}")
        self._assert_shard_local(what, body, state, esc)
        return stats.describe()

    def prove_read_coordination_free(self, batch_per_shard: int = 8) -> str:
        """The RAMP claim, structurally: both read transactions (first
        round, fracture detection and lookback repair) call no collective,
        and each shard's read touches its own slice only, writing nothing.
        The reads run on ``init_state`` after a New-Order batch,
        Order-Status asking for that batch's customers."""
        state = tpcc.init_state(self.scale, device=self.device)
        batch = proof_batch(self, batch_per_shard)
        self.neworder_step(state, batch)
        reads = (
            ("order-status", self.order_status_step,
             self._order_status_shard,
             OrderStatusBatch(batch.w, batch.d, batch.c)),
            ("stock-level", self.stock_level_step, self._stock_level_shard,
             tpcc.home_partitioned(tpcc.generate_stock_level,
                                   np.random.default_rng(0), self,
                                   batch_per_shard)))
        descs = []
        for name, step, shard, b in reads:
            with collectives.counted() as stats:
                step(state, b)
            if stats.total_ops:
                raise AssertionError(f"coordination-free path contains "
                                     f"collectives in RAMP {name} read "
                                     f"path: {stats.describe()}")
            parts = self._parts(b)
            self._assert_shard_local(
                f"RAMP {name} read path",
                lambda st, e, r, shard=shard, parts=parts: shard(
                    st, r, parts[r]), state, read_only=True)
            descs.append(f"{name}: {stats.describe()}")
        return "; ".join(descs)

    def count_read_collectives(self, read_per_shard: int = 2):
        """The collectives of one Order-Status and one Stock-Level read of
        ``read_per_shard`` queries a shard, on ``init_state``: (stats of
        Order-Status, stats of Stock-Level)."""
        state = tpcc.init_state(self.scale, device=self.device)
        rng = np.random.default_rng(0)
        out = []
        for step, gen in ((self.order_status_step,
                           tpcc.generate_order_status),
                          (self.stock_level_step,
                           tpcc.generate_stock_level)):
            batch = tpcc.home_partitioned(gen, rng, self, read_per_shard)
            with collectives.counted() as stats:
                step(state, batch)
            out.append(stats)
        return tuple(out)

    def coordination_ledger(self, **kw):
        """The one-shot proofs as a budget reported with every run:
        per-phase collective calls and bytes on the wire of this engine's
        plan-selected fused closed loop (``repro_torch.obs.ledger.
        build_ledger``'s keywords: chunk_len, batch_per_shard,
        refresh_every, metrics, ...). Hot phases are checked at zero
        collectives before the ledger is returned."""
        from repro_torch.obs.ledger import build_ledger
        return build_ledger(self, **kw)

    def count_anti_entropy_collectives(self, batch_per_shard: int = 8
                                       ) -> collectives.CollectiveStats:
        """The collectives of one anti-entropy drain of a batch's outbox
        (``batch_per_shard * n_shards * max_lines`` entries), on
        ``init_state``."""
        state = tpcc.init_state(self.scale, device=self.device)
        n = batch_per_shard * self.n_shards * self.scale.max_lines
        z = torch.zeros((n,), dtype=torch.int32, device=self.device)
        outbox = StockDelta(z, z, z, torch.zeros_like(z, dtype=torch.bool))
        with collectives.counted() as stats:
            self.anti_entropy(state, outbox)
        return stats

    def count_refresh_collectives(self) -> collectives.CollectiveStats:
        """The escrow regime's only collective program, on
        ``init_state``."""
        self._require_escrow()
        state = tpcc.init_state(self.scale, device=self.device)
        esc = self.init_escrow(state)
        with collectives.counted() as stats:
            self.refresh_escrow(state, esc)
        return stats


def _gather_outbox(outbox: StockDelta, n_shards: int) -> StockDelta:
    """Every shard's part of the outbox, all-gathered shard-major: the
    flattened outbox itself (the reference shards it along its one
    dimension and gathers it back)."""
    flat = StockDelta(*(x.reshape(-1) for x in outbox))
    rows = flat.dst_w.shape[0] // n_shards
    return collectives.all_gather_tree(
        [shard_view(flat, r, rows) for r in range(n_shards)])


def _owned_by(g: StockDelta, r: int, w_per_shard: int) -> torch.Tensor:
    w_lo = r * w_per_shard
    return g.valid & (g.dst_w >= w_lo) & (g.dst_w < w_lo + w_per_shard)


def gather_and_apply_outbox(state: TPCCState, outbox: StockDelta,
                            w_per_shard: int, n_shards: int = 1,
                            restock: bool = True) -> TPCCState:
    """The anti-entropy body: all-gather the outboxes, then every owner
    applies the entries in its slice. Every outbox entry is, by
    construction, remote to its owner."""
    g = _gather_outbox(outbox, n_shards)
    for r in range(n_shards):
        own = _owned_by(g, r, w_per_shard)
        tpcc.apply_stock_updates(shard_view(state, r, w_per_shard),
                                 g.dst_w - r * w_per_shard, g.i_id, g.qty,
                                 own, torch.ones_like(own), restock=restock)
    return state


def gather_and_apply_outbox_strict(state: TPCCState, outbox: StockDelta,
                                   hot_keys: torch.Tensor, w_per_shard: int,
                                   n_items: int, n_shards: int = 1
                                   ) -> tuple[TPCCState, torch.Tensor]:
    """The sparse strict-drain body: all-gather the outboxes, then every
    owner strictly applies the entries in its slice, split by hot-set tier
    (tpcc.apply_stock_updates_strict_tiered). Returns (state, cold-reject
    counts [n_shards], one an owner)."""
    g = _gather_outbox(outbox, n_shards)
    rejects = []
    for r in range(n_shards):
        own = _owned_by(g, r, w_per_shard)
        _, rej = tpcc.apply_stock_updates_strict_tiered(
            shard_view(state, r, w_per_shard), hot_keys, g.dst_w, g.i_id,
            g.qty, own, torch.ones_like(own), n_items,
            w_lo=r * w_per_shard)
        rejects.append(rej.reshape(1))
    return state, cat_shards(rejects)


def gather_and_apply_outbox_strict_retry(
        state: TPCCState, outbox: StockDelta, retry: tpcc.RetryState,
        hot_keys: torch.Tensor, w_per_shard: int, n_items: int,
        n_shards: int = 1, retry_max=0, reserve=0
        ) -> tuple[TPCCState, tpcc.RetryState, torch.Tensor]:
    """The retry-aware sparse strict-drain body: all-gather the outboxes
    (the ring is owner-local and never gathered), then every owner r
    strictly applies the entries in its slice, re-presenting row r of the
    ring first (tpcc.apply_stock_updates_strict_tiered_retry). Returns
    (state, the new ring, its rows stacked owner-major, final-reject
    counts [n_shards])."""
    g = _gather_outbox(outbox, n_shards)
    rings, finals = [], []
    for r in range(n_shards):
        own = _owned_by(g, r, w_per_shard)
        _, ring, final = tpcc.apply_stock_updates_strict_tiered_retry(
            shard_view(state, r, w_per_shard), hot_keys, g.dst_w, g.i_id,
            g.qty, own, torch.ones_like(own),
            tpcc.RetryState(*(x[r] for x in retry)), n_items,
            w_lo=r * w_per_shard, retry_max=retry_max, reserve=reserve)
        rings.append(ring)
        finals.append(final.reshape(1))
    return (state, tpcc.RetryState(*(torch.stack(xs) for xs in zip(*rings))),
            cat_shards(finals))


def _replica_slots(n_shards: int, dims: int, device) -> torch.Tensor:
    return torch.arange(n_shards, dtype=torch.int32, device=device).reshape(
        (n_shards,) + (1,) * dims)


def gather_and_refresh_shares(state: TPCCState, n_shards: int,
                              w_per_shard: int, alive=None) -> EscrowCounter:
    """The dense share-refresh body: all-gather the owners' current stock
    (``[W, I]``, the global table itself) and re-partition it into every
    replica's fresh ``[W, I]`` share; spent resets to zero."""
    q = collectives.all_gather([shard_view(state, r, w_per_shard).s_quantity
                                for r in range(n_shards)])
    shares = tpcc.escrow_share_for(q, _replica_slots(n_shards, 2, q.device),
                                   n_shards, alive=alive)
    return EscrowCounter(shares, torch.zeros_like(shares))


def gather_and_refresh_hot_shares(state: TPCCState, hot_keys: torch.Tensor,
                                  n_shards: int, n_items: int,
                                  w_per_shard: int,
                                  alive=None) -> HotSetEscrow:
    """The sparse share-refresh body: each owner contributes its current
    stock of the hot cells in its slice (0 elsewhere), one ``psum`` over
    ``[K]`` sums them, and every replica gets its fresh share of the sum;
    spent resets to zero."""
    kw = hot_keys // n_items
    ki = hot_keys % n_items
    parts = []
    for r in range(n_shards):
        w_lo = r * w_per_shard
        own = (kw >= w_lo) & (kw < w_lo + w_per_shard)
        q = shard_view(state, r, w_per_shard).s_quantity
        parts.append(torch.where(own, q[torch.where(own, kw - w_lo, 0).long(),
                                        ki.long()], 0))
    q = collectives.psum(parts)
    shares = tpcc.escrow_share_for(q, _replica_slots(n_shards, 1, q.device),
                                   n_shards, alive=alive)
    return HotSetEscrow(hot_keys, shares, torch.zeros_like(shares))


def single_host_engine(scale: TPCCScale, stock_invariant: str = "restock",
                       device=None, **engine_kwargs) -> Engine:
    """Engine on one device: the CUDA card unless ``device`` says
    otherwise (``device="cpu"`` runs the plain versions on the CPU);
    ``n_shards`` (default 1) shards the warehouses on it."""
    return Engine(scale, stock_invariant=stock_invariant, device=device,
                  **engine_kwargs)


def plan_engine(scale: TPCCScale, stock_invariant: str = "restock",
                device=None, n_shards: int = 1, **engine_kwargs):
    """Plan-driven engine selection: run the analyzer over the declared
    TPC-C state specs and return :class:`Engine` when every element is
    COORDINATION_FREE or ESCROW, or the synchronous strict-stock
    ``txn.twopc.TwoPCEngine`` (with ``.plan`` set) when the plan demands
    COORDINATION_REQUIRED: coordination is the fallback, never the
    default."""
    cplan = plan_specs(tpcc_state_specs(stock_invariant))
    if cplan.entry("stock.s_quantity").coord_class is CoordClass.REQUIRED:
        from .twopc import TwoPCEngine
        eng = TwoPCEngine(scale, strict_stock=True, device=device,
                          n_shards=n_shards)
        eng.plan = cplan
        return eng
    return Engine(scale, stock_invariant=stock_invariant, device=device,
                  n_shards=n_shards, **engine_kwargs)
