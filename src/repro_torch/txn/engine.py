"""Coordination-avoiding TPC-C engine on one card (paper §6.2).

The port of ``repro.txn.engine`` for one device (``n_shards == 1``):

* **hot path** — :meth:`Engine.neworder_step` (merge regime) and
  :meth:`Engine.neworder_escrow_step` (escrow regime) run New-Order against
  the local state; remote stock updates are emitted into an outbox;
* **anti-entropy** — :meth:`Engine.anti_entropy` / :meth:`Engine.drain_strict`
  apply the outbox entries each owner holds;
* **escrow refresh** — :meth:`Engine.refresh_escrow`, the regime's amortized
  coordination point, re-partitions the stock into shares (the hot cells'
  in the sparse layout, every cell's in the dense one);
* **the rest of the mix** — :meth:`Engine.payment_step`,
  :meth:`Engine.delivery_step` and the RAMP reads
  :meth:`Engine.order_status_step` and :meth:`Engine.stock_level_step`.

With one shard the reference's all-gather and ``psum`` are the identity;
the bodies below are written so and refuse ``n_shards > 1``.

:func:`plan_engine` is the plan-driven factory: it returns the synchronous
2PC baseline (``txn.twopc.TwoPCEngine``) where the plan demands
coordination, and :class:`Engine` elsewhere.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.analyzer import Strategy
from repro_torch.core.lattice import EscrowCounter, HotSetEscrow
from repro_torch.core.planner import CoordClass, plan as plan_specs
from repro_torch.device import resolve_device

from . import ramp, tpcc
from .tpcc import (NewOrderBatch, OrderStatusBatch, PaymentBatch, StockDelta,
                   StockLevelBatch, TPCCScale, TPCCState, tpcc_state_specs)


def _one_shard(n_shards: int) -> None:
    if n_shards != 1:
        raise NotImplementedError(
            "multi-shard state as a leading dimension is ROADMAP Queue A "
            "item 4; this engine runs one shard")


@dataclasses.dataclass
class Engine:
    """TPC-C on one device, regime chosen by the coordination plan.

    At construction the engine runs ``core.planner.plan()`` over the TPC-C
    state specs; the verdict for STOCK.S_QUANTITY selects the regime:
    COORDINATION_FREE -> merge (outbox + anti-entropy), ESCROW -> strict
    stock over escrow shares, COORDINATION_REQUIRED -> refused
    (:func:`plan_engine` falls back to the 2PC baseline).

    ``escrow_layout`` picks the ESCROW regime's state: "sparse" (default),
    a ``HotSetEscrow`` over the top-K contended cells with the cold tail
    owner-routed through the outbox; "dense", the ``[R, W, I]``
    ``EscrowCounter`` (every replica a share of every cell), the
    comparison baseline. ``admission`` ("auto" | "scan" | "kernel") and
    ``effects`` ("fused" | "scan") pick the escrow regime's strategies
    (both layouts), with bit-identical results.
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
        _one_shard(self.n_shards)
        self.w_per_shard = self.scale.n_warehouses

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
        """The state with every table on this engine's device."""
        return TPCCState(*(x.to(self.device) for x in state))

    def _require_escrow(self):
        if self.stock_regime is not CoordClass.ESCROW:
            raise RuntimeError(
                f"stock regime is {self.stock_regime.value!r}, not escrow — "
                f"construct the engine with stock_invariant='strict'")

    # -- merge regime ---------------------------------------------------------

    def neworder_step(self, state: TPCCState, batch: NewOrderBatch):
        """Hot path: returns (state, outbox, totals)."""
        return tpcc.apply_neworder(state, batch, self.scale, w_lo=0,
                                   w_hi=self.w_per_shard, replica=0,
                                   num_replicas=self.n_shards)

    def anti_entropy(self, state: TPCCState, outbox: StockDelta) -> TPCCState:
        """Apply the outbox entries this shard owns (with restock in the
        merge regime)."""
        return gather_and_apply_outbox(state, outbox, 0, self.w_per_shard,
                                       self.n_shards, restock=self._restock)

    # -- the rest of the five-transaction mix ---------------------------------

    def payment_step(self, state: TPCCState, batch: PaymentBatch
                     ) -> TPCCState:
        return tpcc.apply_payment(state, batch, w_lo=0)

    def delivery_step(self, state: TPCCState
                      ) -> tuple[TPCCState, torch.Tensor]:
        """Deliver one order in every district that has one (carrier 1).
        Returns (state, per-shard delivered-order counts [n_shards] int32)."""
        n = state.no_valid.any(2).sum().to(torch.int32).reshape(1)
        return tpcc.apply_delivery(state, 1, 0), n

    def order_status_step(self, state: TPCCState, batch: OrderStatusBatch
                          ) -> ramp.OrderStatusResult:
        """RAMP read path: atomic visibility, through the fused read."""
        return ramp.apply_order_status(state, batch, w_lo=0)

    def stock_level_step(self, state: TPCCState, batch: StockLevelBatch
                         ) -> ramp.StockLevelResult:
        """RAMP read path: atomic visibility."""
        return ramp.apply_stock_level(state, batch, self.scale, w_lo=0)

    # -- escrow regime (plan-selected; paper §8) ------------------------------

    def init_escrow(self, state: TPCCState):
        """Shares partitioning the current stock: a ``HotSetEscrow`` over
        the K hot cells (sparse layout) or the ``[R, W, I]``
        ``EscrowCounter`` (dense layout)."""
        self._require_escrow()
        if self.escrow_layout == "sparse":
            budgets = state.s_quantity.reshape(-1)[self.hot_keys.long()]
            return HotSetEscrow.make(self.n_shards, self.hot_keys, budgets)
        shares = tpcc.make_escrow_shares(state.s_quantity, self.n_shards)
        return EscrowCounter(shares, torch.zeros_like(shares))

    def neworder_escrow_step(self, state: TPCCState, esc, batch: NewOrderBatch):
        """Strict-stock New-Order with local escrow admission. Returns
        (state, esc, outbox, totals, committed mask)."""
        self._require_escrow()
        kw = dict(w_lo=0, w_hi=self.w_per_shard, replica=0,
                  num_replicas=self.n_shards, admission=self.admission,
                  effects=self.effects)
        if self.escrow_layout == "sparse":
            state, spent, delta, total, ok = \
                tpcc.apply_neworder_escrow_sparse(
                    state, esc.keys, esc.shares[0], esc.spent[0], batch,
                    self.scale, **kw)
        else:
            state, spent, delta, total, ok = tpcc.apply_neworder_escrow(
                state, esc.shares[0], esc.spent[0], batch, self.scale, **kw)
        return state, esc._replace(spent=spent[None]), delta, total, ok

    def refresh_escrow(self, state: TPCCState, esc, alive=None):
        """Re-partition the post-drain stock into fresh shares (the hot
        cells' in the sparse layout, every cell's in the dense one).
        ``alive`` ([n_shards] mask, default all live) gives dead replicas'
        headroom to the survivors."""
        self._require_escrow()
        if alive is None:
            alive = torch.ones((self.n_shards,), dtype=torch.int32,
                               device=self.device)
        if self.escrow_layout == "sparse":
            return gather_and_refresh_hot_shares(
                state, esc.keys, 0, self.n_shards, self.scale.n_items, 0,
                self.w_per_shard, alive=alive)
        return gather_and_refresh_shares(state, 0, self.n_shards,
                                         alive=alive)

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
                state, outbox, self.hot_keys, 0, self.w_per_shard,
                self.scale.n_items, self.n_shards)
        state = gather_and_apply_outbox(state, outbox, 0, self.w_per_shard,
                                        self.n_shards, restock=False)
        return state, torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)

    def escrow_bytes_per_device(self) -> dict:
        """Per-device escrow residency of this engine's layout vs dense."""
        self._require_escrow()
        out = tpcc.escrow_layout_bytes(self.scale, self.hot_items)
        out["layout"] = self.escrow_layout
        out["bytes_per_device"] = out[f"{self.escrow_layout}_bytes_per_device"]
        return out


def _owned(outbox: StockDelta, w_lo: int, w_per_shard: int, n_shards: int):
    """The gathered outbox (one shard: the outbox itself) and the entries
    this shard owns."""
    _one_shard(n_shards)
    dst = outbox.dst_w.reshape(-1)
    own = outbox.valid.reshape(-1) & (dst >= w_lo) & (dst < w_lo
                                                       + w_per_shard)
    return dst, outbox.i_id.reshape(-1), outbox.qty.reshape(-1), own


def gather_and_apply_outbox(state: TPCCState, outbox: StockDelta, w_lo: int,
                            w_per_shard: int, n_shards: int = 1,
                            restock: bool = True) -> TPCCState:
    """The anti-entropy body: apply the outbox entries this shard owns.
    Every outbox entry is, by construction, remote to its owner."""
    dst, i_id, qty, own = _owned(outbox, w_lo, w_per_shard, n_shards)
    return tpcc.apply_stock_updates(state, dst - w_lo, i_id, qty, own,
                                    torch.ones_like(own), restock=restock)


def gather_and_refresh_shares(state: TPCCState, replica: int,
                              n_shards: int, alive=None) -> EscrowCounter:
    """The dense share-refresh body: the owners' current stock (gathered
    across shards: one shard holds it all) re-partitioned into this
    replica's fresh ``[1, W, I]`` share slot; spent resets to zero."""
    _one_shard(n_shards)
    share = tpcc.escrow_share_for(state.s_quantity, replica, n_shards,
                                  alive=alive)
    return EscrowCounter(share[None], torch.zeros_like(share)[None])


def gather_and_apply_outbox_strict(state: TPCCState, outbox: StockDelta,
                                   hot_keys: torch.Tensor, w_lo: int,
                                   w_per_shard: int, n_items: int,
                                   n_shards: int = 1
                                   ) -> tuple[TPCCState, torch.Tensor]:
    """The sparse strict-drain body: strictly apply the owned entries split
    by hot-set tier (tpcc.apply_stock_updates_strict_tiered). Returns
    (state, cold-reject count [1])."""
    dst, i_id, qty, own = _owned(outbox, w_lo, w_per_shard, n_shards)
    state, rejects = tpcc.apply_stock_updates_strict_tiered(
        state, hot_keys, dst, i_id, qty, own, torch.ones_like(own), n_items,
        w_lo=w_lo)
    return state, rejects.reshape(1)


def gather_and_refresh_hot_shares(state: TPCCState, hot_keys: torch.Tensor,
                                  replica: int, n_shards: int, n_items: int,
                                  w_lo: int, w_per_shard: int,
                                  alive=None) -> HotSetEscrow:
    """The sparse share-refresh body: the owners' current stock of the K
    hot cells (summed across shards: one shard holds it all) re-partitioned
    into this replica's fresh share slot; spent resets to zero."""
    _one_shard(n_shards)
    kw = hot_keys // n_items
    ki = hot_keys % n_items
    own = (kw >= w_lo) & (kw < w_lo + w_per_shard)
    q = torch.where(own, state.s_quantity[
        torch.where(own, kw - w_lo, 0).long(), ki.long()], 0)
    share = tpcc.escrow_share_for(q, replica, n_shards, alive=alive)
    return HotSetEscrow(hot_keys, share[None], torch.zeros_like(share)[None])


def single_host_engine(scale: TPCCScale, stock_invariant: str = "restock",
                       device=None, **engine_kwargs) -> Engine:
    """Engine on one device: the CUDA card unless ``device`` says
    otherwise (``device="cpu"`` runs the plain versions on the CPU)."""
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
